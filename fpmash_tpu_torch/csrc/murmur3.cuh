// MurmurHash3_x64_128 of a u64 vector, fed one value at a time.
//
// The hashing unit of the fingerprint kernels (fingerprint.cu, hash_words.cu):
// a vector of `count` u64 values hashes as its 8*count-byte little-endian
// image, as murmur3_u64_batch does (hash.cpp:45-73).  Values pair into 16-byte
// blocks; an odd last value is mixed into h1 only.  State lives in registers.
#pragma once

#include <cstdint>

namespace fpmash {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  k ^= k >> 33;
  return k;
}

struct Murmur64 {
  static constexpr uint64_t kC1 = 0x87C37B91114253D5ull;
  static constexpr uint64_t kC2 = 0x4CF5AD432745937Full;

  uint64_t h1, h2;
  uint64_t k1 = 0;  // first u64 of a half-filled 16-byte block
  int32_t count = 0;

  __device__ explicit Murmur64(uint64_t seed) : h1(seed), h2(seed) {}

  __device__ __forceinline__ void add(uint64_t v) {
    if (count & 1) {
      h1 ^= rotl64(k1 * kC1, 31) * kC2;
      h1 = rotl64(h1, 27) + h2;
      h1 = h1 * 5 + 0x52DCE729ull;
      h2 ^= rotl64(v * kC2, 33) * kC1;
      h2 = rotl64(h2, 31) + h1;
      h2 = h2 * 5 + 0x38495AB5ull;
    } else {
      k1 = v;
    }
    ++count;
  }

  // The closing mix; h1 and h2 hold the hash afterwards.
  __device__ __forceinline__ void finish() {
    if (count & 1) h1 ^= rotl64(k1 * kC1, 31) * kC2;
    const uint64_t byte_len = 8ull * static_cast<uint64_t>(count);
    h1 ^= byte_len;
    h2 ^= byte_len;
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    h1 += h2;
    h2 += h1;
  }
};

}  // namespace fpmash
