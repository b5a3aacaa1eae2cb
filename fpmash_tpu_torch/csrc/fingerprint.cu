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

#include "murmur3.cuh"

namespace {

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

  fpmash::Murmur64 hash(seed);
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
      hash.add(static_cast<uint64_t>(p));
      i += p;
    }
  }
  hash.finish();
  h1_out[b] = hash.h1;
  h2_out[b] = hash.h2;
  count_out[b] = hash.count;
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
