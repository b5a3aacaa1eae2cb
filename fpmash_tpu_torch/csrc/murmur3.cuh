// MurmurHash3_x64_128 pieces, and the hash of a u64 vector fed one value at a time.
//
// The hashing unit of the fingerprint kernels (fingerprint.cu, hash_words.cu):
// a vector of `count` u64 values hashes as its 8*count-byte little-endian
// image, as murmur3_u64_batch does (hash.cpp:45-73).  Values pair into 16-byte
// blocks; an odd last value is mixed into h1 only.  State lives in registers.
// The k-mer kernels (kmer_hash.cu) use the block update, tail mixes and
// closing mix directly on a window's bytes (hash.cpp:12-40).
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

constexpr uint64_t kMurmurC1 = 0x87C37B91114253D5ull;
constexpr uint64_t kMurmurC2 = 0x4CF5AD432745937Full;

// The tail mixes: k1 (bytes 0-7 of a block) goes into h1, k2 (bytes 8-15) into h2.
__device__ __forceinline__ uint64_t mix_k1(uint64_t k1) { return rotl64(k1 * kMurmurC1, 31) * kMurmurC2; }
__device__ __forceinline__ uint64_t mix_k2(uint64_t k2) { return rotl64(k2 * kMurmurC2, 33) * kMurmurC1; }

// One full 16-byte block.
__device__ __forceinline__ void murmur_block(uint64_t& h1, uint64_t& h2, uint64_t k1, uint64_t k2) {
  h1 ^= mix_k1(k1);
  h1 = rotl64(h1, 27) + h2;
  h1 = h1 * 5 + 0x52DCE729ull;
  h2 ^= mix_k2(k2);
  h2 = rotl64(h2, 31) + h1;
  h2 = h2 * 5 + 0x38495AB5ull;
}

// The closing mix over a message of `byte_len` bytes.
__device__ __forceinline__ void murmur_finish(uint64_t& h1, uint64_t& h2, uint64_t byte_len) {
  h1 ^= byte_len;
  h2 ^= byte_len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
}

struct Murmur64 {
  uint64_t h1, h2;
  uint64_t k1 = 0;  // first u64 of a half-filled 16-byte block
  int32_t count = 0;

  __device__ explicit Murmur64(uint64_t seed) : h1(seed), h2(seed) {}

  __device__ __forceinline__ void add(uint64_t v) {
    if (count & 1) {
      murmur_block(h1, h2, k1, v);
    } else {
      k1 = v;
    }
    ++count;
  }

  // Two values at once, on an even count: one block update, no parity branch.
  __device__ __forceinline__ void add_pair(uint64_t a, uint64_t b) {
    murmur_block(h1, h2, a, b);
    count += 2;
  }

  // The closing mix; h1 and h2 hold the hash afterwards.
  __device__ __forceinline__ void finish() {
    if (count & 1) h1 ^= mix_k1(k1);
    murmur_finish(h1, h2, 8ull * static_cast<uint64_t>(count));
  }
};

}  // namespace fpmash
