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
// What bounds it on the card.  The operations: a pair needs at least a 64-bit
// compare and an equality test per merged element up to the cap (about 4
// 32-bit operations each, 4 000 a pair at s = 1000), 23.96 ms for config 4's
// 10^8 pairs on an H100; the bytes (each list read once, 8 bytes of output a
// pair) are two orders of magnitude fewer.  The first design (one warp a pair,
// 32 merged elements a step, each lane finding its one element by a six-round
// merge-path search of 64-bit shuffles, then three ballots: about 34 shuffles
// and 80 warp instructions a step, 2.5 for each merged element) took 572 ms
// there, 4.2 % of the bound.
//
// Design: one warp a pair still, but kW = 32 x kE = 512 merged elements a
// step, kE = 16 for each lane.
//   1. The query's next kWin hashes go into the warp's own window of shared
//      memory (coalesced 8-byte loads, all issued before the stores, 2^64 - 1
//      past the end).  The reference row is staged once for the block (2^64 -
//      1 past its end); a row wider than kStage gets a window a warp as well,
//      so list lengths have no cap.
//   2. Each lane finds where its kE merged elements start, at diagonal
//      kE * lane of the two windows, by one merge-path binary search in
//      shared memory (nine rounds, ties to A as in the walk).
//   3. It merges its kE elements serially: a 64-bit compare, two selects and
//      one shared-memory load from the address of the list it took from, and
//      a mask of the elements equal to the one before (the first element's
//      predecessor is lane - 1's last, or the step before's for lane 0).  The
//      lane's elements ascend, so only a lane whose last element is a pad
//      counts its live ones.
//   4. A warp inclusive scan of the lanes' run-start counts (five shuffles)
//      gives each lane the rank its run starts begin at; the duplicates
//      ranked under the cap are a prefix of the lane's, found by clearing
//      run-start bits.
//   5. The warp stops at the first pad (the lists are sorted, so only pads
//      follow it) or once the union holds more than cap values, after which
//      no element can count; each lane sums its duplicates and one reduction
//      ends the pair.
// That is one search and five shuffles for 512 elements, against about 34
// shuffles for 32 before; `-Xptxas -v`: 40 registers, no spills.  What
// remains is the serial merge: each element's load depends on the compare
// before it, the lanes read at data-dependent addresses (for random data
// about 4-5 lanes to a bank, by count), and the compiled loop spends 15-30
// instructions an element on it (read from `cuobjdump -sass`), about 1 warp
// instruction for each merged element against 2.5 before.  On an H100
// (700 W) it takes 238 ms for config 4's 10^8 pairs, 10 % of the bound,
// against 572 ms.  Measured there and left out: ablations of a step give
// the merge most of the time and the search and window loads the rest;
// padded shared memory, cp.async loads, two or four merge chains a lane,
// and tiles of several references and queries staged together (a third of
// the L2 traffic, half the resident warps) were all no faster.
//
// A block takes one reference row and a group of at most kMaxGroup queries,
// kWarps warps taking them in turn.  The group is sized to Q (ceil(Q /
// ceil(Q / kMaxGroup))), so dist's Q = 100 makes two groups of 50, not one of
// 64 and one of 36.  The blocks resident together take one query group, so
// its lists stay in L2.  The TPU kernel's 8 x 8 pair blocks, power-of-two
// padding, bitonic network and log-step prefix sum existed to fit VMEM lanes;
// none is carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kWarps = 8;             // warps a block
constexpr int kMaxGroup = 64;         // queries a block takes at most
constexpr int kE = 16;                // merged elements a lane takes a step
constexpr int kW = 32 * kE;           // merged elements a warp takes a step
constexpr int kSlack = 32;            // window entries past kW: a lane reads up to entry kW
constexpr int kWin = kW + kSlack;     // a warp's window of a list
constexpr int64_t kStage = 4096;      // widest reference row staged whole in shared memory
constexpr u64 kPad = ~0ull;           // the pad, also past a list's end
constexpr unsigned kAll = 0xffffffffu;

static_assert(kE < 32 && kWin % 32 == 0,
              "masks are 32 bits; lanes fill a window in whole rounds");

__device__ __forceinline__ unsigned shared_address(const u64* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ u64 load_shared(unsigned address) {
  u64 v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(address));
  return v;
}

// list[start, start + kWin) into the warp's window, kPad from n on.  All
// loads are issued before the first store.
__device__ __forceinline__ void fill_window(u64* win, const u64* __restrict__ list, int32_t start,
                                            int32_t n, int lane) {
  u64 v[kWin / 32];
#pragma unroll
  for (int m = 0; m < kWin / 32; ++m) {
    const int32_t t = start + lane + 32 * m;
    v[m] = t < n ? list[t] : kPad;
  }
#pragma unroll
  for (int m = 0; m < kWin / 32; ++m) win[lane + 32 * m] = v[m];
}

// (common, #run starts) of one pair, the whole warp taking part; the counts
// are returned to every lane.  `stage` holds the reference row whole (kPad
// from la on) or is null, and the row is then read through the window wa.
__device__ __forceinline__ void count_pair(const u64* stage, const u64* __restrict__ A,
                                           int32_t la, const u64* __restrict__ B, int32_t lb,
                                           u64* wa, u64* wb, int32_t cap, int lane,
                                           int32_t& common_out, int32_t& starts_out) {
  int32_t i = 0, j = 0, starts = 0, common = 0;
  u64 last = kPad;  // no live element equals it: element 0 is a start
  const int diag = kE * lane;
  while (true) {
    __syncwarp();  // every lane has read the last windows
    fill_window(wb, B, j, lb, lane);
    if (stage == nullptr) fill_window(wa, A, i, la, lane);
    __syncwarp();
    const u64* a_win = stage == nullptr ? wa : stage + i;

    // merge path of diagonal kE * lane, ties to A: x of the first diag
    // merged elements come from A
    int lo = 0, hi = diag;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a_win[mid] <= wb[diag - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // merge kE elements; pa and pb address the next element of each window
    const unsigned a0 = shared_address(a_win), b0 = shared_address(wb);
    unsigned pa = a0 + 8 * lo, pb = b0 + 8 * (diag - lo);
    u64 a = load_shared(pa), b = load_shared(pb), first = 0, prev = 0;
    unsigned eq = 0;  // bit e: element e equals the element before it
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const bool take_a = a <= b;
      const u64 v = take_a ? a : b;
      if (e == 0) {
        first = v;
      } else if (v == prev) {
        eq |= 1u << e;
      }
      prev = v;
      if (take_a) {
        pa += 8;
      } else {
        pb += 8;
      }
      const u64 next = load_shared(take_a ? pa : pb);
      a = take_a ? next : a;
      b = take_a ? b : next;
    }
    const int x = static_cast<int>(pa - a0) >> 3;  // A's share of the first diag + kE
    // live: below 2^64 - 1.  The lane's elements ascend, so only a lane
    // whose last one is a pad holds pads, and its live ones come first.
    unsigned live = (1u << kE) - 1;
    if (prev == kPad) {
      int n = 0;
      for (int t = lo; t < x; ++t) n += a_win[t] != kPad;
      for (int t = diag - lo; t < diag + kE - x; ++t) n += wb[t] != kPad;
      live = (1u << n) - 1;
    }
    u64 before = __shfl_up_sync(kAll, prev, 1);  // lane - 1's last element
    if (lane == 0) before = last;
    eq |= static_cast<unsigned>(first == before);
    const unsigned start = live & ~eq;
    const unsigned dup = live & eq;
    const int c = __popc(start);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += t;
    }
    // the lane's duplicates before its (k + 1)-th run start rank under the cap
    const int32_t k = cap - (starts + incl - c);
    if (dup && k >= 0) {
      if (k >= c) {
        common += __popc(dup);
      } else {
        unsigned s = start;
        for (int n = 0; n < k; ++n) s &= s - 1;
        common += __popc(dup & ((s & (0u - s)) - 1));
      }
    }
    starts += __shfl_sync(kAll, incl, 31);
    const u64 tail = __shfl_sync(kAll, prev, 31);
    if (tail == kPad || starts > cap) break;
    last = tail;
    const int took_a = __shfl_sync(kAll, x, 31);
    i += took_a;
    j += kW - took_a;
  }
  common_out = static_cast<int32_t>(__reduce_add_sync(kAll, static_cast<unsigned>(common)));
  starts_out = starts;
}

// Block b takes query group b / n_ref and reference b % n_ref, so the blocks
// resident together share their queries in L2.
__global__ void __launch_bounds__(kWarps * 32)
compare_kernel(const u64* __restrict__ ref, const int32_t* __restrict__ ref_len, int64_t n_ref,
               int64_t ref_stride, const u64* __restrict__ qry,
               const int32_t* __restrict__ qry_len, int64_t n_qry, int64_t qry_stride,
               int64_t group, bool staged, int32_t cap, int32_t* __restrict__ common_out,
               int32_t* __restrict__ denom_out) {
  extern __shared__ u64 smem[];
  const int64_t g = static_cast<int64_t>(blockIdx.x) / n_ref;
  const int64_t r = static_cast<int64_t>(blockIdx.x) - g * n_ref;
  const int64_t q0 = g * group;
  const int64_t q_end = min(q0 + group, n_qry);
  // lengths beyond the padded width, or negative, are clamped to it
  const int32_t la = min(max(ref_len[r], 0), static_cast<int32_t>(ref_stride));
  const u64* A = ref + r * ref_stride;
  const int64_t stage_len = staged ? ref_stride + kWin : 0;
  if (staged) {
    for (int t = threadIdx.x; t < la + kWin; t += blockDim.x) smem[t] = t < la ? A[t] : kPad;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64* wb = smem + stage_len + warp * kWin;
  u64* wa = smem + stage_len + (kWarps + warp) * kWin;  // used only when not staged
  for (int64_t q = q0 + warp; q < q_end; q += kWarps) {  // the same for the whole warp
    const int32_t lb = min(max(qry_len[q], 0), static_cast<int32_t>(qry_stride));
    int32_t common, starts;
    count_pair(staged ? smem : nullptr, A, la, qry + q * qry_stride, lb, wa, wb, cap, lane,
               common, starts);
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
  const int64_t n_groups = (n_qry + kMaxGroup - 1) / kMaxGroup;
  const int64_t group = (n_qry + n_groups - 1) / n_groups;
  const int64_t blocks = n_ref * n_groups;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the reference row whole and a window of pads past it, then one window a
  // warp for the query; a row wider than kStage gets one window a warp too
  const bool staged = ref_stride <= kStage;
  const int64_t entries = staged ? ref_stride + kWin + kWarps * kWin : 2 * kWarps * kWin;
  const size_t smem = static_cast<size_t>(entries) * sizeof(u64);
  const cudaError_t err = cudaFuncSetAttribute(
      compare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  compare_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(ref), static_cast<const int32_t*>(ref_len), n_ref, ref_stride,
      static_cast<const u64*>(qry), static_cast<const int32_t*>(qry_len), n_qry, qry_stride,
      group, staged, sketch_size, static_cast<int32_t*>(common), static_cast<int32_t*>(denom));
  return static_cast<int>(cudaGetLastError());
}
