// Merge-join walk kernel: `dist` over unsorted (file-order) hash lists.
//
// Replaces the Pallas kernel fpmash_tpu/ops/walk_pallas.py:41 _walk_kernel
// (reached through pairwise_walk_pallas from ops/walk.py:87).  For each
// (reference, query) pair it runs the literal capped merge-join of
// CommandDistance.cpp:376-400 over the two lists in the order they are
// stored, which on unsorted fingerprint lists is order-dependent and has no
// closed form:
//
//   live = denom < s && i < la && j < lb: advance i on a <= b, j on b <= a,
//   count common on a == b, add one to denom; after the loop, when denom is
//   still below s, denom = min(denom + (la - i) + (lb - j), s).
//
// Design: one thread per pair, walking ref[r, :la] and qry[q, :lb] straight
// from device memory, with the hashes compared as unsigned 64-bit values.
// The TPU kernel's shift-register lane rolls, its pair packing and its
// multiple-of-8 row tiles existed to avoid gathers on the TPU and are not
// carried over.  Pairs are numbered reference-major, so the threads of a
// block mostly take consecutive queries of one reference and share its row
// through L1.
//
// What bounds it on the card: the walk is serial, up to min(s, la + lb) steps
// of two dependent loads each, so it is latency-bound; divergence makes a
// warp wait for its longest walk.  Staging the reference row in shared memory
// is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void walk_kernel(const uint64_t* __restrict__ ref, const int32_t* __restrict__ ref_len,
                            int64_t n_ref, int64_t ref_stride,
                            const uint64_t* __restrict__ qry, const int32_t* __restrict__ qry_len,
                            int64_t n_qry, int64_t qry_stride, int32_t sketch_size,
                            int32_t* __restrict__ common_out, int32_t* __restrict__ denom_out) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pair >= n_ref * n_qry) return;
  const int64_t r = pair / n_qry;
  const int64_t q = pair - r * n_qry;
  // lengths beyond the padded width, or negative, are clamped to it
  const int32_t la = min(max(ref_len[r], 0), static_cast<int32_t>(ref_stride));
  const int32_t lb = min(max(qry_len[q], 0), static_cast<int32_t>(qry_stride));
  const uint64_t* __restrict__ A = ref + r * ref_stride;
  const uint64_t* __restrict__ B = qry + q * qry_stride;

  int32_t i = 0, j = 0, common = 0, denom = 0;
  while (denom < sketch_size && i < la && j < lb) {
    const uint64_t a = A[i], b = B[j];
    if (a < b) {
      ++i;
    } else if (b < a) {
      ++j;
    } else {
      ++i;
      ++j;
      ++common;
    }
    ++denom;
  }
  if (denom < sketch_size) {
    denom = min(denom + (la - i) + (lb - j), sketch_size);
  }
  common_out[pair] = common;
  denom_out[pair] = denom;
}

}  // namespace

extern "C" int fpmash_walk(const void* ref, const void* ref_len, int64_t n_ref, int64_t ref_stride,
                           const void* qry, const void* qry_len, int64_t n_qry, int64_t qry_stride,
                           int32_t sketch_size, void* common, void* denom, void* stream) {
  if (n_ref <= 0 || n_qry <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 128;
  const int64_t blocks = (n_ref * n_qry + kThreads - 1) / kThreads;
  walk_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(ref), static_cast<const int32_t*>(ref_len), n_ref, ref_stride,
      static_cast<const uint64_t*>(qry), static_cast<const int32_t*>(qry_len), n_qry, qry_stride,
      sketch_size, static_cast<int32_t*>(common), static_cast<int32_t*>(denom));
  return static_cast<int>(cudaGetLastError());
}
