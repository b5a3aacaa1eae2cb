// Fingerprint kernel: Duval (CFL) factorization + MurmurHash3_x64_128 per window.
//
// Replaces the Pallas kernel fpmash_tpu/ops/fused_pallas.py:339 _split_kernel
// (reached through fingerprint_hashes_fused and fingerprint_hashes_fused_words).
// For each window it computes MurmurHash3_x64_128 (seed `seed`) of the u64
// vector of the window's CFL factor lengths, and the factor count: the odd
// last length is mixed into h1 only and the byte length is 8 * count, as
// murmur3_u64_batch does.
//
// Design: one thread per window.  Duval's i/j/k state lives in registers and
// every emitted factor length goes straight into the 64-bit murmur block
// update (the inline formulation of fused_pallas.py:233-276), so the factor
// lengths never reach memory.  The TPU kernel's layout (sublane groups, the
// boundary bitmask phase, the binary select tree over packed words) existed
// to keep 8x128 vector lanes busy and is not carried over.
//
// Input is one flat byte stream: the host ships each read once (upper case,
// followed by its first 99 bytes for the cyclic shift windows) and names each
// window by its start offset and length.  Bytes compare as unsigned, which
// keeps A<C<G<T and orders any other byte exactly as the TPU kernel's byte4
// packing did.  A window that does not lie inside the stream gets count -1
// and zero hashes instead of being read.
//
// What bounds it on the card: not memory (about one byte read per Duval step,
// mostly from L1/L2 since neighbouring threads read overlapping windows) but
// the serial Duval loop, about 2-3 steps per character, and warp divergence:
// a warp waits for its slowest window.  Staging a block's span of the stream
// in shared memory and balancing windows across warps are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kC1 = 0x87C37B91114253D5ull;
constexpr uint64_t kC2 = 0x4CF5AD432745937Full;

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

__device__ __forceinline__ uint64_t mix_k1(uint64_t k1) {
  return rotl64(k1 * kC1, 31) * kC2;
}

__device__ __forceinline__ uint64_t mix_k2(uint64_t k2) {
  return rotl64(k2 * kC2, 33) * kC1;
}

__global__ void fingerprint_kernel(const uint8_t* __restrict__ flat, int64_t n_flat,
                                   const int64_t* __restrict__ starts,
                                   const int32_t* __restrict__ lengths, int64_t n_windows,
                                   uint64_t seed, uint64_t* __restrict__ h1_out,
                                   uint64_t* __restrict__ h2_out,
                                   int32_t* __restrict__ count_out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_windows) return;
  const int64_t start = starts[b];
  const int32_t n = lengths[b];
  if (start < 0 || n < 0 || start > n_flat - n) {
    h1_out[b] = 0;
    h2_out[b] = 0;
    count_out[b] = -1;
    return;
  }
  const uint8_t* __restrict__ s = flat + start;

  uint64_t h1 = seed, h2 = seed;
  uint64_t k1 = 0;  // first u64 of a half-filled 16-byte block
  int32_t count = 0;
  int32_t i = 0;
  while (i < n) {
    // scan the longest prefix of s[i:] that is a power of a Lyndon word
    int32_t j = i + 1, k = i;
    while (j < n) {
      const uint8_t a = s[k], c = s[j];
      if (a > c) break;
      k = (a < c) ? i : k + 1;
      ++j;
    }
    const int32_t p = j - k;
    // emit its factors, each of length p
    while (i <= k) {
      if (count & 1) {
        h1 ^= mix_k1(k1);
        h1 = rotl64(h1, 27) + h2;
        h1 = h1 * 5 + 0x52DCE729ull;
        h2 ^= mix_k2(static_cast<uint64_t>(p));
        h2 = rotl64(h2, 31) + h1;
        h2 = h2 * 5 + 0x38495AB5ull;
      } else {
        k1 = static_cast<uint64_t>(p);
      }
      ++count;
      i += p;
    }
  }
  if (count & 1) h1 ^= mix_k1(k1);

  const uint64_t byte_len = 8ull * static_cast<uint64_t>(count);
  h1 ^= byte_len;
  h2 ^= byte_len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
  h1_out[b] = h1;
  h2_out[b] = h2;
  count_out[b] = count;
}

}  // namespace

extern "C" int fpmash_fingerprint(const void* flat, int64_t n_flat, const void* starts,
                                  const void* lengths, int64_t n_windows, uint64_t seed,
                                  void* h1, void* h2, void* count, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t blocks = (n_windows + kThreads - 1) / kThreads;
  fingerprint_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), n_flat, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(lengths), n_windows, seed, static_cast<uint64_t*>(h1),
      static_cast<uint64_t*>(h2), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fpmash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
