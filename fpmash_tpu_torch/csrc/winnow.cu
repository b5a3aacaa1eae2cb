// Minmer selection of windowed sketches (sketch -W, find): the marks of the
// positions that some window of ws consecutive positions selects.
//
// Replaces the XLA jit fpmash_tpu/ops/winnow.py:105 _make_chunk_jit (its
// kernel at :110; no Pallas kernel), reached through minmer_positions.  With
// h the per-position hashes (u64, unsigned order) and prev[p] the previous
// occurrence of h[p] (-1 if none), window W(s) = [s, s + ws) for each start
// s in [0, n - ws]:
//
//   t(s) = the mins-th smallest distinct value of W(s) (2^64 - 1 when W(s)
//          has fewer; 0 when mins < 1);
//   p is marked iff, for some s with p in W(s), h[p] <= t(s) and prev[p] < s.
//
// The JAX route gathers the [C, ws] windows of C starts and sorts each row,
// ws times the work of each position; the plain PyTorch version does the
// same.  This kernel gathers no window.
//
// Ranges.  p is the first occurrence of h[p] in W(s) exactly for s in
// R(p) = [max(prev[p] + 1, p - ws + 1), p], and the ranges of one value's
// occurrences are disjoint.  So each distinct value of W(s) has one position
// whose range holds s, and h[p] <= t(s) iff fewer than mins positions q with
// h[q] < h[p] have s in R(q).  p is marked iff some s in R(p) has fewer.
//
// Design.  A block takes a tile of R starts [s0, s0 + R) (the wrapper picks
// R <= ws / 2, or R = 1 for one window; for a window of a few positions, a
// tile of many starts).  Its span [s0, s0 + R - 1 + ws) holds every window
// of the tile; all of them hold the core [s0 + R - 1, s0 + ws), so every
// t(s) is at most T, the mins-th smallest distinct value of the core (2^64 -
// 1 when R > ws leaves the core empty).
//  1. One pass reads the span from device memory (16-byte loads where the
//     hashes and prev share an alignment) and stages it in shared memory:
//     the hashes and, for each position, f = its range's first start in the
//     tile (relative, clamped to [0, R]; f < R makes it a candidate).  The
//     same pass counts the span's and the core's distinct values and the
//     core's least and greatest first occurrence, lo and hi.  A span too
//     long for shared memory is read in place by the same code.
//  2. A span of fewer than mins values (or mins < 1, T = 0) marks every
//     candidate at or below T at once.  A core of fewer than mins values
//     gives T = 2^64 - 1.  Otherwise one histogram over [lo, hi] in 2 048
//     bins of the core's and the span's candidates gives the bin holding
//     the core's mins-th value: its upper edge is T' >= T, and the span's
//     counts up to it the candidates.  A looser bound admits more
//     candidates but gives the same marks, since the sweep counts exactly.
//     Only while the candidates overflow their room is the bin refined by
//     another pass inside it (11 bits more a pass).
//  3. The candidates (h <= T', f < R) are gathered as indices into the span
//     (warp-aggregated atomics) into shared memory, or the block's region of
//     device-memory scratch past `cap`, and sorted by hash: by rank (a
//     thread counts the candidates below its own) up to one a thread, by a
//     bitonic network past that.
//  4. The sweep: thread t counts, in registers, the candidates seen so far
//     whose range holds each of its K starts [t K, t K + K).  Each warp
//     streams the sorted candidates 32 at a time (a lane loads one and its
//     range in the tile, [a, b]) and ballots them: those whose range covers
//     all the warp's starts (most of them: ranges are about ws long) only
//     add to a warp-wide count g, and one is flagged while g plus the least
//     count of the warp is below mins; those that cover some of its starts
//     are taken in order, each broadcast by a shuffle: a thread flags it
//     where a start in [a, b] has counted fewer than mins, then counts it.
//     A warp stops once every start has counted mins.  A repeat of a value
//     costs a warp one lane's load, and its threads' work only where its
//     range meets the warp's starts.  No searches, no load chains.
//  5. Flagged candidates are marked; several blocks may store the same 1.
//
// What bounds it on the card: the function reads h and prev once (16 bytes
// a position) and writes the marks once (1 byte): 17 n bytes over 3.35 TB/s,
// 0.025 ms over a 5 Mbase chromosome.  The kernel reads each span once,
// (ws + R - 1) / R positions a start (4.3 at -L 10 000 and R = 3 072; most
// from L2, since neighbouring tiles share their spans), then works in shared
// memory and registers.  At -L 10 000 a staged span and room for all its
// candidates take 224 KB, so one block of 1 024 threads holds an SM: its
// passes over the span and their barriers are not overlapped with another
// block's work, and they, not the bytes, set its time (PERF.md §6).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The shared-memory layout; ops/winnow.py keeps a copy of kBins, kMiscBytes
// and kSmemMax to plan a launch, and the entry point rejects a plan that
// does not fit.
constexpr int kBins = 2048;  // histogram bins
constexpr int kBinBits = 11;
constexpr int kMiscBytes = 512;
constexpr int kSmemMax = 232448;  // 227 KB a block
constexpr int kRankMax = 1024;    // candidates the rank sort takes at most
constexpr uint64_t kMax = ~0ull;
constexpr uint32_t kPad = 0xffffffffu;  // the index of a bitonic pad
constexpr uint32_t kNone = 0x80000000u;  // the count of a start past the tile
constexpr unsigned kAll = 0xffffffffu;

// The block's counters, after the two histograms in shared memory.
struct Misc {
  unsigned long long lo, hi;  // the core's least and greatest first occurrence
  uint32_t core_values, span_values, span_cands;
  uint32_t core_below, span_below;  // candidates below the histogram's base
  uint32_t bin, upto;               // the picked bin, the span's candidates up to it
  uint32_t count;                   // the gather's slots
  unsigned long long warp_sums[32];
};
static_assert(sizeof(Misc) <= kMiscBytes, "Misc outgrows its room");

__device__ __forceinline__ int32_t range_start(int64_t prev, int64_t s0, int32_t R) {
  const int64_t f = prev + 1 - s0;
  return f < 0 ? 0 : (f > R ? R : static_cast<int32_t>(f));
}

// The tile's span: staged in shared memory, or read in place.
struct Span {
  const uint64_t* gh;  // h + s0
  const int64_t* gp;   // prev + s0
  const uint64_t* sh;  // staged hashes (null: read in place)
  const uint16_t* sf;  // staged range starts
  int64_t s0;
  int32_t R;
  __device__ __forceinline__ uint64_t hash(int32_t i) const { return sh ? sh[i] : gh[i]; }
  __device__ __forceinline__ int32_t f(int32_t i) const {
    return sh ? static_cast<int32_t>(sf[i]) : range_start(gp[i], s0, R);
  }
  __device__ __forceinline__ uint64_t key(uint32_t i) const {
    return i == kPad ? kMax : hash(static_cast<int32_t>(i));
  }
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) { return __reduce_add_sync(kAll, v); }

// Thread t owns bins [t per, (t + 1) per) of the core's and the span's
// histograms (packed: core low, span high); a block exclusive scan; the
// thread whose core counts reach k walks its bins and writes the bin and
// the span's candidates up to it.
__device__ void pick_bin(const uint32_t* chist, const uint32_t* shist, uint32_t k, Misc* misc) {
  const int per = kBins / blockDim.x;
  const int b0 = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t sum = 0;
  for (int j = 0; j < per; ++j)
    sum += static_cast<uint64_t>(chist[b0 + j]) | (static_cast<uint64_t>(shist[b0 + j]) << 32);
  uint64_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) misc->warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const uint64_t w = lane < nw ? misc->warp_sums[lane] : 0;
    uint64_t wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t t = __shfl_up_sync(kAll, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < nw) misc->warp_sums[lane] = wi - w;
  }
  __syncthreads();
  const uint64_t excl = misc->warp_sums[warp] + incl - sum;
  uint32_t c = static_cast<uint32_t>(excl), s = static_cast<uint32_t>(excl >> 32);
  if (c < k && c + static_cast<uint32_t>(sum) >= k) {
    for (int j = 0; j < per; ++j) {
      c += chist[b0 + j];
      s += shist[b0 + j];
      if (c >= k) {
        misc->bin = b0 + j;
        misc->upto = s;
        break;
      }
    }
  }
}

// Ascending bitonic sort of idx[0, p2) by (hash, index), p2 a power of two.
__device__ void bitonic_sort(const Span& sp, uint32_t* idx, uint32_t p2) {
#pragma unroll 1
  for (uint32_t k = 2; k <= p2; k <<= 1) {
#pragma unroll 1
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      for (uint32_t i = threadIdx.x; i < p2 / 2; i += blockDim.x) {
        const uint32_t lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const uint32_t hi = lo | j;
        const uint32_t ia = idx[lo], ib = idx[hi];
        const uint64_t ka = sp.key(ia), kb = sp.key(ib);
        const bool b_less = kb < ka || (kb == ka && ib < ia);
        const bool a_less = ka < kb || (ka == kb && ia < ib);
        if ((lo & k) == 0 ? b_less : a_less) idx[lo] = ib, idx[hi] = ia;
      }
      __syncthreads();
    }
  }
}

template <int K>
__global__ void __launch_bounds__(1024)
winnow_kernel(const uint64_t* __restrict__ h, const int64_t* __restrict__ prev, int64_t n,
              int64_t ws, int32_t mins, int64_t tile, int64_t tile0, uint32_t cap, int32_t stage,
              uint32_t* __restrict__ scratch_idx, uint8_t* __restrict__ scratch_flag,
              uint32_t scratch_cap, uint8_t* __restrict__ marks) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* chist = reinterpret_cast<uint32_t*>(smem);
  uint32_t* shist = chist + kBins;
  Misc* misc = reinterpret_cast<Misc*>(shist + kBins);
  const int lane = threadIdx.x & 31;

  const int64_t s0 = (tile0 + blockIdx.x) * tile;
  const int32_t R = static_cast<int32_t>(min(tile, n - ws + 1 - s0));
  const int32_t W = static_cast<int32_t>(ws);
  const int32_t span = R + W - 1;
  unsigned char* at = smem + kBins * 8 + kMiscBytes;
  uint64_t* sh = nullptr;
  if (stage) sh = reinterpret_cast<uint64_t*>(at), at += 8ll * span;
  uint32_t* idx = reinterpret_cast<uint32_t*>(at);
  at += 4ll * cap;
  uint16_t* sf = nullptr;
  if (stage) sf = reinterpret_cast<uint16_t*>(at), at += 2ll * span;
  uint8_t* flag = at;
  const Span sp{h + s0, prev + s0, sh, sf, s0, R};

  if (threadIdx.x == 0) {
    misc->lo = kMax, misc->hi = 0;
    misc->core_values = misc->span_values = misc->span_cands = 0;
  }
  __syncthreads();

  // 1. the span, read once: staged, and counted
  {
    uint32_t cd = 0, sd = 0, sc = 0;
    uint64_t lo = kMax, hi = 0;
    auto visit = [&](int32_t i, uint64_t v, int64_t pv) {
      const int32_t f = range_start(pv, s0, R);
      if (sh) sh[i] = v, sf[i] = static_cast<uint16_t>(f);
      sc += f < R;
      sd += f == 0;
      if (f < R && i >= R - 1 && i < W) ++cd, lo = min(lo, v), hi = max(hi, v);
    };
    const uint64_t* gh = sp.gh;
    const int64_t* gp = sp.gp;
    const uintptr_t ah = reinterpret_cast<uintptr_t>(gh), ap = reinterpret_cast<uintptr_t>(gp);
    const int32_t head = ((ah ^ ap) & 15) == 0 ? min(static_cast<int32_t>((ah >> 3) & 1), span)
                                               : span;
    const int32_t pairs = (span - head) / 2;
    for (int32_t i = threadIdx.x; i < head; i += blockDim.x) visit(i, gh[i], gp[i]);
    constexpr int kU = 2;  // pairs in flight a thread
    for (int32_t j0 = threadIdx.x; j0 < pairs; j0 += kU * blockDim.x) {
      ulonglong2 hv[kU];
      longlong2 pv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int32_t j = j0 + u * blockDim.x;
        if (j < pairs) {
          hv[u] = __ldg(reinterpret_cast<const ulonglong2*>(gh + head + 2 * j));
          pv[u] = __ldg(reinterpret_cast<const longlong2*>(gp + head + 2 * j));
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int32_t j = j0 + u * blockDim.x;
        if (j < pairs) {
          visit(head + 2 * j, hv[u].x, pv[u].x);
          visit(head + 2 * j + 1, hv[u].y, pv[u].y);
        }
      }
    }
    for (int32_t i = head + 2 * pairs + threadIdx.x; i < span; i += blockDim.x)
      visit(i, gh[i], gp[i]);
    cd = warp_sum(cd), sd = warp_sum(sd), sc = warp_sum(sc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kAll, lo, o));
      hi = max(hi, __shfl_xor_sync(kAll, hi, o));
    }
    if (lane == 0) {
      atomicAdd(&misc->core_values, cd);
      atomicAdd(&misc->span_values, sd);
      atomicAdd(&misc->span_cands, sc);
      if (cd) atomicMin(&misc->lo, lo), atomicMax(&misc->hi, hi);
    }
  }
  __syncthreads();
  const uint32_t umins = static_cast<uint32_t>(max(mins, 0));

  // 2. a span of fewer than mins values: every candidate at or below T
  if (mins < 1 || misc->span_values < umins) {
    const uint64_t t = mins < 1 ? 0 : kMax;
    for (int32_t i = threadIdx.x; i < span; i += blockDim.x)
      if (sp.f(i) < R && sp.hash(i) <= t) marks[s0 + i] = 1;
    return;
  }
  uint64_t t = kMax;
  uint32_t nc = misc->span_cands;
  if (misc->core_values >= umins) {  // the bound from the histograms
    uint64_t base = misc->lo;
    const uint64_t range = misc->hi - base;
    int shift = max(64 - (range ? __clzll(range) : 64) - kBinBits, 0);
    for (;;) {
      for (int b = threadIdx.x; b < 2 * kBins; b += blockDim.x) chist[b] = 0;
      if (threadIdx.x == 0) misc->core_below = misc->span_below = 0;
      __syncthreads();
      uint32_t cb = 0, sb = 0;
      for (int32_t i = threadIdx.x; i < span; i += blockDim.x) {
        if (sp.f(i) >= R) continue;
        const uint64_t v = sp.hash(i);
        const bool core = i >= R - 1 && i < W;
        if (v < base) {
          ++sb, cb += core;
          continue;
        }
        const uint64_t d = (v - base) >> shift;
        if (d < kBins) {
          atomicAdd(&shist[d], 1u);
          if (core) atomicAdd(&chist[d], 1u);
        }
      }
      cb = warp_sum(cb), sb = warp_sum(sb);
      if (lane == 0 && (cb | sb)) atomicAdd(&misc->core_below, cb), atomicAdd(&misc->span_below, sb);
      __syncthreads();
      pick_bin(chist, shist, umins - misc->core_below, misc);
      __syncthreads();
      const uint64_t edge = base + (static_cast<uint64_t>(misc->bin) << shift);
      const uint64_t mask = (1ull << shift) - 1;
      t = kMax - edge < mask ? kMax : edge + mask;
      nc = misc->span_below + misc->upto;
      if (nc <= cap || shift == 0) break;
      base = edge, shift = max(shift - kBinBits, 0);
      __syncthreads();  // every thread has read the counters
    }
  }

  // 3. the candidates: indices into the span, gathered, then sorted by hash
  if (nc > cap) {
    idx = scratch_idx + static_cast<int64_t>(blockIdx.x) * scratch_cap;
    flag = scratch_flag + static_cast<int64_t>(blockIdx.x) * scratch_cap;
  }
  if (threadIdx.x == 0) misc->count = 0;
  __syncthreads();
  for (int32_t i0 = threadIdx.x & ~31; i0 < span; i0 += blockDim.x) {
    const int32_t i = i0 + lane;
    const bool take = i < span && sp.f(i) < R && sp.hash(i) <= t;
    const unsigned m = __ballot_sync(kAll, take);
    uint32_t slot = 0;
    if (lane == 0 && m) slot = atomicAdd(&misc->count, static_cast<uint32_t>(__popc(m)));
    slot = __shfl_sync(kAll, slot, 0);
    if (take) idx[slot + __popc(m & ((1u << lane) - 1))] = static_cast<uint32_t>(i);
  }
  __syncthreads();
  if (nc <= blockDim.x) {  // by rank, ties by gather slot, in the histograms' room
    uint64_t* keys = reinterpret_cast<uint64_t*>(chist);
    uint32_t* out = reinterpret_cast<uint32_t*>(keys + kRankMax);
    uint32_t mine = 0;
    uint64_t key = 0;
    if (threadIdx.x < nc) mine = idx[threadIdx.x], key = sp.hash(mine), keys[threadIdx.x] = key;
    __syncthreads();
    if (threadIdx.x < nc) {
      uint32_t rank = 0;
#pragma unroll 4
      for (uint32_t j = 0; j < nc; ++j) {
        const uint64_t kj = keys[j];
        rank += kj < key || (kj == key && j < threadIdx.x);
      }
      out[rank] = mine;
    }
    __syncthreads();
    if (threadIdx.x < nc) idx[threadIdx.x] = out[threadIdx.x];
  } else {
    const uint32_t p2 = 1u << (32 - __clz(nc - 1));
    for (uint32_t r = nc + threadIdx.x; r < p2; r += blockDim.x) idx[r] = kPad;
    __syncthreads();
    bitonic_sort(sp, idx, p2);
  }
  for (uint32_t r = threadIdx.x; r < nc; r += blockDim.x) flag[r] = 0;
  __syncthreads();

  // 4. the sweep.  used(s) = g + used[k]: g counts the candidates that
  // covered all the warp's starts, used[k] (registers) the others that
  // covered start mine + k; wmin is the least used[k] of the warp.
  const int32_t wb = (threadIdx.x >> 5) * 32 * K;
  if (wb < R) {
    const int32_t we = min(wb + 32 * K, R);
    const int32_t mine = threadIdx.x * K;
    uint32_t used[K];
#pragma unroll
    for (int k = 0; k < K; ++k) used[k] = mine + k < R ? 0 : kNone;
    uint32_t g = 0, wmin = 0;
    for (uint32_t c0 = 0; c0 < nc && g + wmin < umins; c0 += 32) {
      const uint32_t r = c0 + lane;
      int32_t a = INT_MAX, b = -1;
      if (r < nc) {
        const int32_t i = static_cast<int32_t>(idx[r]);
        a = max(sp.f(i), i - (W - 1));
        b = min(i, R - 1);
      }
      const bool hit = a < we && b >= wb;
      const bool full = hit && a <= wb && b >= we - 1;
      const unsigned fm = __ballot_sync(kAll, full);
      unsigned pm = __ballot_sync(kAll, hit && !full);
      uint32_t at_wmin = wmin;  // wmin when this lane's candidate comes
      bool flagged = false;
      while (pm) {  // the candidates that cover some of the warp's starts
        const int j = __ffs(pm) - 1;
        pm &= pm - 1;
        const int32_t aj = __shfl_sync(kAll, a, j), bj = __shfl_sync(kAll, b, j);
        const uint32_t gj = g + __popc(fm & ((1u << j) - 1));
        bool fl = false;
        uint32_t least = kNone;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = mine + k >= aj && mine + k <= bj;
          fl |= in && gj + used[k] < umins;
          used[k] += in;
          least = min(least, used[k]);
        }
        wmin = __reduce_min_sync(kAll, least);
        const bool any = __any_sync(kAll, fl);
        if (lane == j) flagged = any;
        if (lane > j) at_wmin = wmin;
      }
      // one that covers all of them: flagged while some start has a count left
      if (full) flagged = g + __popc(fm & ((1u << lane) - 1)) + at_wmin < umins;
      if (flagged) flag[r] = 1;
      g += __popc(fm);
    }
  }
  __syncthreads();

  // 5. the marks
  for (uint32_t r = threadIdx.x; r < nc; r += blockDim.x)
    if (flag[r]) marks[s0 + idx[r]] = 1;
}

template <int K>
int launch(const void* h, const void* prev, int64_t n, int64_t ws, int32_t mins, int64_t tile,
           int64_t tile0, int64_t n_tiles, int32_t threads, uint32_t cap, int32_t stage,
           void* scratch_idx, void* scratch_flag, int64_t scratch_cap, void* marks, size_t smem,
           cudaStream_t stream) {
  static size_t configured[64] = {};  // the shared memory set, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && (dev >= 64 || smem > configured[dev])) {
    e = cudaFuncSetAttribute(winnow_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) configured[dev] = smem;
  }
  winnow_kernel<K><<<static_cast<unsigned int>(n_tiles), threads, smem, stream>>>(
      static_cast<const uint64_t*>(h), static_cast<const int64_t*>(prev), n, ws, mins, tile,
      tile0, cap, stage, static_cast<uint32_t*>(scratch_idx),
      static_cast<uint8_t*>(scratch_flag), static_cast<uint32_t>(scratch_cap),
      static_cast<uint8_t*>(marks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Marks of the tiles [tile0, tile0 + n_tiles) of `tile` starts each, over
// hashes h[0, n) (u64) with their previous occurrences prev (int64), window
// ws and mins (ops/winnow.launch_plan picks the geometry).  A block of
// `threads` threads (a power of two, 32-1 024) takes a tile of at most
// `starts` (1, 2 or 4) starts a thread, stages its span when `stage`
// and keeps `cap` (a power of two) candidates in shared memory; a block with
// more uses its region of scratch_cap (at least the span rounded up to a
// power of two) entries of the scratch arrays, which may be null when cap
// covers that.  marks (uint8 [n]) is only ever set to 1.
extern "C" int fpmash_winnow(const void* h, const void* prev, int64_t n, int64_t ws, int32_t mins,
                             int64_t tile, int64_t tile0, int64_t n_tiles,
                             int32_t threads, int32_t starts, int32_t cap, int32_t stage,
                             void* scratch_idx, void* scratch_flag, int64_t scratch_cap,
                             void* marks, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool pow2_threads = threads >= 32 && threads <= 1024 && (threads & (threads - 1)) == 0;
  if (ws < 1 || ws > n || tile < 1 || tile0 < 0 || n_tiles > 0x7fffffff || !pow2_threads ||
      (tile0 + n_tiles - 1) * tile > n - ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t span = ws + tile - 1;
  int64_t need = 1;
  while (need < span) need <<= 1;
  const bool scratch_ok = need <= cap || (scratch_idx && scratch_flag && scratch_cap >= need &&
                                          scratch_cap <= 0x80000000ll);
  const size_t smem = kBins * 8 + kMiscBytes + (stage ? 10 * span : 0) + 5ll * cap;
  if (tile >= 65535 || span >= 0x7fffffff || cap < 1 || (cap & (cap - 1)) != 0 ||
      !(starts == 1 || starts == 2 || starts == 4) || tile > static_cast<int64_t>(starts) * threads ||
      !scratch_ok || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t c = static_cast<uint32_t>(cap);
  switch (starts) {
    case 1:
      return launch<1>(h, prev, n, ws, mins, tile, tile0, n_tiles, threads, c, stage, scratch_idx,
                       scratch_flag, scratch_cap, marks, smem, st);
    case 2:
      return launch<2>(h, prev, n, ws, mins, tile, tile0, n_tiles, threads, c, stage, scratch_idx,
                       scratch_flag, scratch_cap, marks, smem, st);
    default:
      return launch<4>(h, prev, n, ws, mins, tile, tile0, n_tiles, threads, c, stage, scratch_idx,
                       scratch_flag, scratch_cap, marks, smem, st);
  }
}
