// Sorted all-pairs comparison kernel: `dist` and `triangle` over sorted sketches.
//
// Replaces the Pallas kernel fpmash_tpu/ops/compare_pallas.py:41 _compare_kernel
// (reached through pairwise_common_denom_pallas, :109, from ops/compare.py:122).
// For each (reference, query) pair it takes the multiset of the live elements
// of A[:la] and B[:lb] (an element equal to 2^64 - 1 is a pad, not live) in
// ascending unsigned order and counts
//
//   run start: an element that differs from its predecessor;
//   rank:      the run starts up to and including the element, minus 1;
//   common  =  #{elements equal to their predecessor with rank < cap};
//   denom   =  min(#run starts, cap),
//
// which on sorted distinct lists is the capped merge-join walk of
// CommandDistance.cpp:365-430.  Both lists must be sorted ascending as
// unsigned values; the plain version (ops/compare.py) sorts, and takes any
// order.
//
// Design: one warp per pair.  The warp walks the merged order 32 elements a
// step.  Lane l holds A[i + l] and B[j + l] (2^64 - 1 past a list's end), and
// a merge-path binary search over the two 32-element windows (six rounds of
// shuffles) tells it how many of the first l + 1 merged elements come from A,
// so it takes merged element l.  Its predecessor comes from lane l - 1 (lane
// 0 keeps the last element of the step before).  A ballot of the run starts
// and __popc give every lane its rank, a second ballot counts the duplicates
// under the cap.  The warp stops at the first pad (the lists are sorted, so
// only pads follow it) or once the union holds more than cap values, after
// which no element can count.  A step costs about 34 shuffles; a pair takes
// about min(cap + common, la + lb) / 32 steps, as the walk takes
// min(cap, la + lb) iterations.
//
// A block takes one reference row and 64 queries (8 warps of 8 queries each).
// The row is staged in shared memory when it holds at most kStage hashes and
// read from global memory (through L1) otherwise, so list lengths have no cap.
// The TPU kernel's 8 x 8 pair blocks, power-of-two padding, bitonic network of
// log2(2 S2) stages and log-step prefix sum existed to fit VMEM lanes; none is
// carried over.
//
// What bounds it on the card: integer operations.  A pair needs at least a
// 64-bit compare and an equality test per merged element up to the cap (about
// 4 32-bit operations each, 6 000 a pair at s = 1000); the bytes (each list
// read once, 8 bytes of output a pair) are two orders of magnitude fewer.
// This design spends the shuffles of its search on every 32 elements; merging
// several elements per lane between searches is the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                    // warps per block
constexpr int kQueriesPerWarp = 8;           // queries each warp takes in turn
constexpr int kQueriesPerBlock = kWarps * kQueriesPerWarp;
constexpr int64_t kStage = 4096;             // reference hashes staged in shared memory
constexpr unsigned long long kPad = ~0ull;   // the pad, also past a list's end
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v, int src) {
  return __shfl_sync(kAll, v, src);
}

__global__ void __launch_bounds__(kWarps * 32)
compare_kernel(const unsigned long long* __restrict__ ref, const int32_t* __restrict__ ref_len,
               int64_t ref_stride, const unsigned long long* __restrict__ qry,
               const int32_t* __restrict__ qry_len, int64_t n_qry, int64_t qry_stride,
               int32_t cap, int32_t* __restrict__ common_out, int32_t* __restrict__ denom_out) {
  extern __shared__ unsigned long long stage[];
  const int64_t q_blocks = (n_qry + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int64_t r = static_cast<int64_t>(blockIdx.x) / q_blocks;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) - r * q_blocks) * kQueriesPerBlock;
  // lengths beyond the padded width, or negative, are clamped to it
  const int32_t la = min(max(ref_len[r], 0), static_cast<int32_t>(ref_stride));
  const unsigned long long* A = ref + r * ref_stride;
  if (la <= kStage) {
    for (int t = threadIdx.x; t < la; t += blockDim.x) stage[t] = A[t];
    A = stage;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned upto_lane = lane == 31 ? kAll : (1u << (lane + 1)) - 1;
  for (int k = 0; k < kQueriesPerWarp; ++k) {
    const int64_t q = q0 + warp + static_cast<int64_t>(k) * kWarps;
    if (q >= n_qry) break;  // the same for the whole warp
    const int32_t lb = min(max(qry_len[q], 0), static_cast<int32_t>(qry_stride));
    const unsigned long long* B = qry + q * qry_stride;

    int32_t i = 0, j = 0, starts = 0, common = 0;
    unsigned long long last = kPad;  // no live element equals it: element 0 is a start
    while (true) {
      const unsigned long long a = i + lane < la ? A[i + lane] : kPad;
      const unsigned long long b = j + lane < lb ? B[j + lane] : kPad;
      // merge path of diagonal lane + 1 over the windows, ties to A: lo is
      // how many of the first lane + 1 merged elements come from A
      const int diag = lane + 1;
      int lo = 0, hi = diag;
#pragma unroll
      for (int round = 0; round < 6; ++round) {  // ceil(log2(33)) rounds close [0, 32]
        const int mid = (lo + hi) >> 1;
        const unsigned long long am = shfl64(a, mid & 31);
        const unsigned long long bm = shfl64(b, (diag - 1 - mid) & 31);
        if (lo < hi) {
          if (am <= bm) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
      }
      int before = __shfl_up_sync(kAll, lo, 1);  // A's share of the first `lane` elements
      if (lane == 0) before = 0;
      const unsigned long long from_a = shfl64(a, before & 31);
      const unsigned long long from_b = shfl64(b, (lane - before) & 31);
      const unsigned long long v = lo > before ? from_a : from_b;
      unsigned long long prev = __shfl_up_sync(kAll, v, 1);
      if (lane == 0) prev = last;

      const bool live = v != kPad;
      const bool start = live && v != prev;
      const unsigned start_bits = __ballot_sync(kAll, start);
      const int32_t rank = starts + __popc(start_bits & upto_lane) - 1;
      common += __popc(__ballot_sync(kAll, live && !start && rank < cap));
      starts += __popc(start_bits);
      if (__ballot_sync(kAll, live) != kAll || starts > cap) break;
      last = shfl64(v, 31);
      const int took_a = __shfl_sync(kAll, lo, 31);
      i += took_a;
      j += 32 - took_a;
    }
    if (lane == 0) {
      common_out[r * n_qry + q] = common;
      denom_out[r * n_qry + q] = min(starts, cap);
    }
  }
}

}  // namespace

extern "C" int fpmash_compare(const void* ref, const void* ref_len, int64_t n_ref,
                              int64_t ref_stride, const void* qry, const void* qry_len,
                              int64_t n_qry, int64_t qry_stride, int32_t sketch_size,
                              void* common, void* denom, void* stream) {
  if (n_ref <= 0 || n_qry <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = n_ref * ((n_qry + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(ref_stride < kStage ? ref_stride : kStage) *
                      sizeof(unsigned long long);
  compare_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(ref), static_cast<const int32_t*>(ref_len),
      ref_stride, static_cast<const unsigned long long*>(qry),
      static_cast<const int32_t*>(qry_len), n_qry, qry_stride, sketch_size,
      static_cast<int32_t*>(common), static_cast<int32_t*>(denom));
  return static_cast<int>(cudaGetLastError());
}
