// Bitonic row sort of (key, payload) u32 planes: K15.
//
// Replaces the Pallas kernel fpmash_tpu/ops/sort_pallas.py:28 _psort_kernel
// (reached through row_sort_planes_pallas; unrouted in the JAX package, whose
// bottom-k stays on lax.sort).  Each row of 4 096 pairs is sorted ascending
// by key as unsigned, the payload moving with its key.
//
// It runs the TPU kernel's network exactly: stages s = 2, 4, ..., 4096 and
// distances d = s/2, ..., 1; element i meets i ^ d; the pair is ascending iff
// (i & s) == 0; and it swaps only on a strict inequality, so equal keys never
// move past each other.  Hence the payload order among equal keys, and not
// only the keys, equals the TPU kernel's (lax.sort orders ties otherwise).
//
// Design: one block of 1 024 threads a row, the row's keys and payloads in
// shared memory (32 KB); each thread takes two of the 2 048 pairs of a step,
// and a barrier ends each of the 78 steps.  The lane rolls and selects of the
// TPU form are not carried over.
//
// What bounds it on the card: the 78 barrier-separated steps of shared-memory
// compare-exchanges (about 5 operations each, 1.6e5 a row), not the 32 KB a
// row read and written once.  Sorting runs of a warp in registers with
// shuffles before the shared-memory stages is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4096;
constexpr int kThreads = 1024;

__global__ void row_sort_kernel(const uint32_t* __restrict__ keys,
                                const uint32_t* __restrict__ payload,
                                uint32_t* __restrict__ out_keys,
                                uint32_t* __restrict__ out_payload) {
  __shared__ uint32_t key[kCols];
  __shared__ uint32_t val[kCols];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCols;
  for (int i = threadIdx.x; i < kCols; i += kThreads) {
    key[i] = keys[base + i];
    val[i] = payload[base + i];
  }
  __syncthreads();
  for (int s = 2; s <= kCols; s <<= 1) {
    for (int d = s >> 1; d >= 1; d >>= 1) {
      for (int t = threadIdx.x; t < kCols / 2; t += kThreads) {
        // the t-th pair (i, i + d) with bit d of i clear
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        const int j = i | d;
        const uint32_t a = key[i], b = key[j];
        const bool swap = (i & s) == 0 ? b < a : a < b;
        if (swap) {
          key[i] = b;
          key[j] = a;
          const uint32_t v = val[i];
          val[i] = val[j];
          val[j] = v;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kCols; i += kThreads) {
    out_keys[base + i] = key[i];
    out_payload[base + i] = val[i];
  }
}

}  // namespace

// K15 over n_rows rows of 4 096 pairs.
extern "C" int fpmash_row_sort(const void* keys, const void* payload, int64_t n_rows,
                               void* out_keys, void* out_payload, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  row_sort_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(payload),
      static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_payload));
  return static_cast<int>(cudaGetLastError());
}
