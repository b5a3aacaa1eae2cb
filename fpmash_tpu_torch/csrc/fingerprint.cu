// Fingerprint kernels: Duval (CFL) factorization + MurmurHash3_x64_128 per window (K1, K13).
//
// Replace the Pallas kernels of fpmash_tpu/ops/fused_pallas.py reached through
// fingerprint_hashes_fused and fingerprint_hashes_fused_words:
//   fingerprint_kernel       _split_kernel (:339, K1; variant "split", routed)
//   fingerprint_rows_kernel  _fused_kernel (:189, K13; variant "inline")
// For each window they compute MurmurHash3_x64_128 (seed `seed`) of the u64
// vector of the window's CFL factor lengths, and the factor count: the odd
// last length is mixed into h1 only and the byte length is 8 * count, as
// murmur3_u64_batch does.
//
// Design: one thread per window, both kernels calling one __device__ body,
// duval_murmur.  Duval's i/j/k state lives in registers and every emitted
// factor length goes straight into the 64-bit murmur block update (the inline
// formulation of fused_pallas.py:233-276), so the factor lengths never reach
// memory.  The TPU kernels' layouts (sublane groups, the boundary bitmask
// phase, the binary select tree over packed words, the [L, R] transpose of
// the inline kernel) existed to keep 8x128 vector lanes busy and are not
// carried over.  K1 and K13 differ only in their input:
//
//   K1 reads one flat byte stream: the host ships each read once (upper case,
//   followed by its first 99 bytes for the cyclic shift windows) and names
//   each window by its start offset and length.  Bytes compare as unsigned,
//   which keeps A<C<G<T and orders any other byte exactly as the TPU kernel's
//   byte4 packing did.  A window that does not lie inside the stream gets
//   count -1 and zero hashes instead of being read.
//
//   K13 reads u8 rows [B, L] with lengths in [0, L] (the wrapper checks them),
//   under the JAX function's two packings: byte4 compares raw bytes; dna16
//   compares the codes C -> 1, G -> 2, T -> 3 and any other byte -> 0, so an
//   N compares like an A (fused_pallas.py:583-589).
//
// What bounds it on the card: not memory (about one byte read per Duval step,
// mostly from L1/L2 since neighbouring threads read overlapping windows, or a
// row's own bytes in K13) but the serial Duval loop, about 2-3 steps per
// character, and warp divergence: a warp waits for its slowest window.
// Staging a block's span of the stream in shared memory and balancing windows
// across warps are left for later.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

// Identity on bytes (K1, and K13 under byte4).
struct RawBytes {
  __device__ __forceinline__ uint8_t operator()(uint8_t b) const { return b; }
};

// K13 under dna16: C G T -> 1 2 3, every other byte -> 0.
struct Dna16Codes {
  __device__ __forceinline__ uint8_t operator()(uint8_t b) const {
    return b == 'C' ? 1 : b == 'G' ? 2 : b == 'T' ? 3 : 0;
  }
};

// MurmurHash3 of the CFL factor lengths of s[0, n), characters compared
// after `code`.
template <class Code>
__device__ __forceinline__ void duval_murmur(const uint8_t* __restrict__ s, int32_t n, Code code,
                                             fpmash::Murmur64& hash) {
  int32_t i = 0;
  while (i < n) {
    // scan the longest prefix of s[i:] that is a power of a Lyndon word
    int32_t j = i + 1, k = i;
    while (j < n) {
      const uint8_t a = code(s[k]), c = code(s[j]);
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
}

// K1: windows (starts, lengths) of a flat byte stream.
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
  fpmash::Murmur64 hash(seed);
  duval_murmur(flat + start, n, RawBytes{}, hash);
  h1_out[b] = hash.h1;
  h2_out[b] = hash.h2;
  count_out[b] = hash.count;
}

// K13: row b is rows[b, 0 : lengths[b]].
template <class Code>
__global__ void fingerprint_rows_kernel(const uint8_t* __restrict__ rows, int64_t n_rows,
                                        int32_t width, const int32_t* __restrict__ lengths,
                                        uint64_t seed, uint64_t* __restrict__ h1_out,
                                        uint64_t* __restrict__ h2_out,
                                        int32_t* __restrict__ count_out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  fpmash::Murmur64 hash(seed);
  duval_murmur(rows + b * width, lengths[b], Code{}, hash);
  h1_out[b] = hash.h1;
  h2_out[b] = hash.h2;
  count_out[b] = hash.count;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int fpmash_fingerprint(const void* flat, int64_t n_flat, const void* starts,
                                  const void* lengths, int64_t n_windows, uint64_t seed,
                                  void* h1, void* h2, void* count, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_windows + kThreads - 1) / kThreads;
  fingerprint_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), n_flat, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(lengths), n_windows, seed, static_cast<uint64_t*>(h1),
      static_cast<uint64_t*>(h2), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

// K13 over rows [n_rows, width]; pack 0 is byte4, 1 is dna16.
extern "C" int fpmash_fingerprint_rows(const void* rows, int64_t n_rows, int32_t width,
                                       const void* lengths, int32_t pack, uint64_t seed,
                                       void* h1, void* h2, void* count, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const auto blocks = static_cast<unsigned int>((n_rows + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(rows);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* o1 = static_cast<uint64_t*>(h1);
  auto* o2 = static_cast<uint64_t*>(h2);
  auto* oc = static_cast<int32_t*>(count);
  if (pack == 1) {
    fingerprint_rows_kernel<Dna16Codes><<<blocks, kThreads, 0, s>>>(in, n_rows, width, len, seed,
                                                                    o1, o2, oc);
  } else {
    fingerprint_rows_kernel<RawBytes><<<blocks, kThreads, 0, s>>>(in, n_rows, width, len, seed,
                                                                  o1, o2, oc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fpmash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
