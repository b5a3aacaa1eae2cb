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
// prev[p] < s with p in W(s) says p is the first occurrence of h[p] in W(s),
// so each start marks the first occurrences of its mins smallest distinct
// values.  The JAX route gathers the [C, ws] windows of C starts and sorts
// each row, ws times the work of each position; the plain PyTorch version
// does the same.  This kernel gathers no window.
//
// Design: a block takes a tile of R <= ws consecutive starts [s0, s1) (the
// wrapper picks R).  Every window of the tile contains the core
// [s1 - 1, s0 + ws), so every t(s) of the tile is at most
//
//   T = the mins-th smallest distinct value of the core (2^64 - 1 if fewer),
//
// found by a block-level radix select (8 passes of 8 bits over the core's
// first occurrences, prev[p] < s1 - 1, a 256-bin histogram in shared
// memory).  Any position that a start of the tile marks lies in the span
// [s0, s1 - 1 + ws), has h[p] <= T and prev[p] < s1 - 1: those are the
// candidates (for random hashes about mins (ws + R) / (ws - R) of them; for
// a run of few values about R plus the values).  They are collected into
// shared memory, or into the block's region of device-memory scratch when
// more than `cap` of them arrive (the same code on other pointers), and
// sorted by (hash, position) with a bitonic network.  One thread a start
// then walks the distinct hashes in ascending order: for each, a galloping
// search finds the first position >= s of that hash; if it is < s + ws it is
// the hash's first occurrence in W(s), so the start counts it and flags it,
// and stops at the mins-th.  The work of a start is bounded by the distinct
// hashes of the tile, not by their repeats, so low-complexity sequence
// (satellites, poly-A) costs no more than random.  Flags are kept a
// candidate in the block's memory and written to the marks once a block:
// several blocks may store the same 1 to a byte, which is benign.
//
// What bounds it on the card: the function reads h and prev once (16 bytes
// a position) and writes the marks once (1 byte): 17 n bytes over 3.35 TB/s.
// The kernel reads each core about 8 times (from L2: neighbouring tiles
// share most of their cores) and spends its time in the select's passes and
// the starts' searches in shared memory; it is far from that bound (PERF.md).
// TMA staging of the core and a warp-level select are later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;  // radix select: 8 passes of 8 bits
constexpr uint64_t kMax = ~0ull;
constexpr uint32_t kPadPos = 0xffffffffu;  // past every real relative position
constexpr unsigned kAll = 0xffffffffu;

// The candidates of a block: hash, position relative to s0, flag.
struct Candidates {
  uint64_t* key;
  uint32_t* pos;
  uint8_t* flag;
};

__device__ __forceinline__ bool pair_less(uint64_t ka, uint32_t pa, uint64_t kb, uint32_t pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// Warp 0 picks the bin of histogram `hist` that holds the k-th (1-based)
// entry: sel[0] = the bin, sel[1] = k's rank inside it; sel[0] = kBins when
// the histogram holds fewer than k entries.
__device__ __forceinline__ void pick_bin(const uint32_t* hist, uint32_t k, uint32_t* sel) {
  const int lane = threadIdx.x;
  uint32_t c[kBins / 32];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kBins / 32; ++i) {
    c[i] = hist[lane * (kBins / 32) + i];
    sum += c[i];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned hit = __ballot_sync(kAll, incl >= k);
  if (hit == 0) {
    if (lane == 0) sel[0] = kBins;
  } else if (lane == __ffs(hit) - 1) {
    uint32_t cum = incl - sum;
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) {
      if (cum + c[i] >= k) {
        sel[0] = lane * (kBins / 32) + i;
        sel[1] = k - cum;
        break;
      }
      cum += c[i];
    }
  }
}

// The mins-th smallest hash among the core [c0, c1)'s positions with
// prev[p] < c0 (its distinct values), or kMax if there are fewer.
__device__ uint64_t core_threshold(const uint64_t* __restrict__ h, const int64_t* __restrict__ prev,
                                   int64_t c0, int64_t c1, uint32_t mins, uint32_t* hist,
                                   uint32_t* sel) {
  uint64_t prefix = 0, mask = 0;
  uint32_t k = mins;
#pragma unroll 1
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int64_t p = c0 + threadIdx.x; p < c1; p += blockDim.x) {
      if (prev[p] < c0) {
        const uint64_t v = h[p];
        if ((v & mask) == prefix) atomicAdd(&hist[(v >> shift) & (kBins - 1)], 1u);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) pick_bin(hist, k, sel);
    __syncthreads();
    const uint32_t bin = sel[0];
    if (bin == kBins) return kMax;  // only in the first pass: fewer than mins values
    k = sel[1];
    prefix |= static_cast<uint64_t>(bin) << shift;
    mask |= static_cast<uint64_t>(kBins - 1) << shift;
  }
  return prefix;
}

// Ascending bitonic sort of c[0, p) by (key, pos), p a power of two.
__device__ void bitonic_sort(Candidates c, uint32_t p) {
#pragma unroll 1
  for (uint32_t k = 2; k <= p; k <<= 1) {
#pragma unroll 1
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      for (uint32_t i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const uint32_t lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const uint32_t hi = lo | j;
        const uint64_t ka = c.key[lo], kb = c.key[hi];
        const uint32_t pa = c.pos[lo], pb = c.pos[hi];
        const bool swap = (lo & k) == 0 ? pair_less(kb, pb, ka, pa) : pair_less(ka, pa, kb, pb);
        if (swap) {
          c.key[lo] = kb, c.key[hi] = ka;
          c.pos[lo] = pb, c.pos[hi] = pa;
        }
      }
      __syncthreads();
    }
  }
}

// The first index in [i, n) whose (key, pos) is not below (v, at) when
// `by_pos`, or whose key is above v when not: a galloping search from i.
__device__ __forceinline__ uint32_t gallop(Candidates c, uint32_t i, uint32_t n, uint64_t v,
                                           uint32_t at, bool by_pos) {
  auto ok = [&](uint32_t x) {
    const uint64_t kx = c.key[x];
    return kx > v || (by_pos && kx == v && c.pos[x] >= at);
  };
  if (i >= n || ok(i)) return i;
  uint32_t lo = i, hi = n, step = 1;  // ok(lo) is false; the answer is in (lo, hi]
  while (step < n - lo) {
    if (ok(lo + step)) {
      hi = lo + step;
      break;
    }
    lo += step;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (ok(mid))
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads)
winnow_kernel(const uint64_t* __restrict__ h, const int64_t* __restrict__ prev, int64_t n,
              int64_t ws, int32_t mins, int64_t tile, int64_t tile0, uint32_t cap,
              uint64_t* __restrict__ scratch_key, uint32_t* __restrict__ scratch_pos,
              uint8_t* __restrict__ scratch_flag, uint32_t scratch_cap,
              uint8_t* __restrict__ marks) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);  // kBins
  uint32_t* misc = hist + kBins;                        // sel[2], count
  Candidates c{reinterpret_cast<uint64_t*>(misc + 4), nullptr, nullptr};
  c.pos = reinterpret_cast<uint32_t*>(c.key + cap);
  c.flag = reinterpret_cast<uint8_t*>(c.pos + cap);

  const int64_t num_w = n - ws + 1;
  const int64_t s0 = (tile0 + blockIdx.x) * tile;
  const int64_t s1 = min(s0 + tile, num_w);
  const int64_t last = s1 - 1;  // every window of the tile holds [last, s0 + ws)
  const uint64_t t =
      mins < 1 ? 0 : core_threshold(h, prev, last, s0 + ws, static_cast<uint32_t>(mins), hist, misc);

  // candidates of the span [s0, last + ws), gathered in any order
  uint32_t* count = misc + 2;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (int64_t p = s0 + threadIdx.x; p < last + ws; p += blockDim.x) {
    if (prev[p] < last && h[p] <= t) {
      const uint32_t i = atomicAdd(count, 1u);
      if (i < cap) c.key[i] = h[p], c.pos[i] = static_cast<uint32_t>(p - s0);
    }
  }
  __syncthreads();
  const uint32_t nc = *count;
  if (nc > cap) {  // too many for shared memory: the block's device-memory region
    __syncthreads();  // every thread has read the count
    const int64_t base = static_cast<int64_t>(blockIdx.x) * scratch_cap;
    c = Candidates{scratch_key + base, scratch_pos + base, scratch_flag + base};
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
    for (int64_t p = s0 + threadIdx.x; p < last + ws; p += blockDim.x) {
      if (prev[p] < last && h[p] <= t) {
        const uint32_t i = atomicAdd(count, 1u);
        c.key[i] = h[p], c.pos[i] = static_cast<uint32_t>(p - s0);
      }
    }
  }
  uint32_t p2 = 1;
  while (p2 < nc) p2 <<= 1;
  for (uint32_t i = threadIdx.x; i < p2; i += blockDim.x) {
    if (i >= nc) c.key[i] = kMax, c.pos[i] = kPadPos;
    c.flag[i] = 0;
  }
  __syncthreads();
  bitonic_sort(c, p2);

  // one thread a start: the first occurrences in W(s) of its smallest hashes
  const uint32_t limit = mins < 1 ? UINT_MAX : static_cast<uint32_t>(mins);
  for (int64_t s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const uint32_t lo = static_cast<uint32_t>(s - s0);
    const uint64_t hi = lo + static_cast<uint64_t>(ws);
    uint32_t counted = 0, i = 0;
    while (i < nc && counted < limit) {
      const uint64_t v = c.key[i];
      const uint32_t j = gallop(c, i, nc, v, lo, true);
      if (j < nc && c.key[j] == v && c.pos[j] < hi) {
        c.flag[j] = 1;
        ++counted;
      }
      i = gallop(c, j, nc, v, 0, false);
    }
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < nc; i += blockDim.x)
    if (c.flag[i]) marks[s0 + c.pos[i]] = 1;
}

}  // namespace

// Marks of the tiles [tile0, tile0 + n_tiles) of `tile` starts each, over
// hashes h[0, n) (u64) with their previous occurrences prev (int64), window
// ws and mins.  `cap` (a power of two) candidates fit in shared memory; a
// block with more uses its region of scratch_cap (a power of two, at least
// the span ws + tile - 1) entries of the scratch arrays, which may be null
// when cap covers the span.  marks (uint8 [n]) is only ever set to 1.
extern "C" int fpmash_winnow(const void* h, const void* prev, int64_t n, int64_t ws, int32_t mins,
                             int64_t tile, int64_t tile0, int64_t n_tiles, int32_t cap,
                             void* scratch_key, void* scratch_pos, void* scratch_flag,
                             int64_t scratch_cap, void* marks, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int64_t span = ws + tile - 1;
  const bool pow2 = cap > 0 && (cap & (cap - 1)) == 0;
  const bool scratch_ok = span <= cap || (scratch_key && scratch_pos && scratch_flag &&
                                          scratch_cap >= span && scratch_cap <= 0x80000000ll &&
                                          (scratch_cap & (scratch_cap - 1)) == 0);
  if (ws < 1 || ws > n || tile < 1 || tile > ws || !pow2 || !scratch_ok || span >= 0x7fffffff ||
      tile0 < 0 || (tile0 + n_tiles - 1) * tile > n - ws || n_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kBins + 4) * sizeof(uint32_t) + static_cast<size_t>(cap) * 13;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        winnow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  winnow_kernel<<<static_cast<unsigned int>(n_tiles), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(h), static_cast<const int64_t*>(prev), n, ws, mins, tile,
      tile0, static_cast<uint32_t>(cap), static_cast<uint64_t*>(scratch_key),
      static_cast<uint32_t*>(scratch_pos), static_cast<uint8_t*>(scratch_flag),
      static_cast<uint32_t>(scratch_cap), static_cast<uint8_t*>(marks));
  return static_cast<int>(cudaGetLastError());
}
