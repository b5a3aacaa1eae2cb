// Factor-start words of any lyn2vec factorization family, one thread per window.
//
// Replaces two Pallas kernels: fpmash_tpu/ops/icfl_pallas.py:88
// _icfl_words_kernel (the ICFL automaton, reached through icfl_words_fused) and
// fpmash_tpu/ops/lyndon_pallas.py:30 _duval_block_kernel (the Duval boundary
// mask, reached through cfl_boundaries_pallas), and carries the mask algebra of
// fpmash_tpu/ops/factorize.py:factor_boundary_mask that composes them:
//
//   CFL          Duval starts
//   ICFL         bit 0 | ICFL automaton over the whole row
//   CFL_ICFL-T   Duval starts | ICFL automaton inside each Duval factor > T
//   *_COMB       the same base on the reverse complement (A<->T, C<->G, any
//                other byte 'N'), each cut c in [1, n-1] OR-ed in as n - c with
//                the row's own n; the rc side of CFL_ICFL_COMB-T uses T = 30.
//
// Output: words[b, w] bit p&31 of word p>>5 set where a factor starts at p (bit
// 0 set when n > 0), and ok[b] = 1.  A window that does not lie inside the
// stream, is wider than 32 * n_words, or (ICFL plans) wider than the call's
// max_len gets zero words and ok 0.
//
// What bounds it on the card: the serial automatons, about 2.1-2.3 steps a
// character over both strands, each step one or two dependent loads, and the
// lanes of a warp that are in different phases of their windows (with every
// window the same, a step costs 1.6-1.8x less on one H100).  Memory is not
// the bound (a window's 100 bytes in, 16 bytes of words out).  The design
// keeps the steps' loads in shared memory or registers and enough warps in
// flight to hide them:
//
//   Strands staged once.  A block takes consecutive windows.  Where their span
//   of the stream fits the block's cap (shift windows always: 256 windows of
//   100 span at most 256 + 2 * 99 bytes), it is staged into shared memory with
//   16-byte loads, and its reverse complement beside it, each byte complemented
//   once by a byte permute.  Window b's reverse strand is then the contiguous
//   slice at span_len - (start_b - span0) - n_b of the staged complement, read
//   like the forward one.  Other blocks (arbitrary starts, the generalized
//   mode's 300-character chunks, whole reads) read device memory through the
//   same automaton code over a second pair of text types.
//   State-minimal ICFL scratch, as icfl_pallas.py:10-26 keeps it: st[] holds one
//   entry a position, indexed by absolute position (uint8 up to 255 characters,
//   uint16 above); a level commits one candidate-boundary bit and parks its
//   bound `last` in the dead slot st[old base]; the merge walks the candidate
//   bits from highest to lowest (__clz), reading `last` as st[prev].  CFL_ICFL
//   folds each Duval factor's segment before the next segment's candidates are
//   set.  Scratch is sized to the call's widest window, in dynamic shared
//   memory, laid out position-major (entry p of thread t at p * T + t).
//   Rows written once.  Up to 128 characters a window's start bits and its
//   candidate bits are four uint32 registers each, set through selects on
//   c >> 5; above, per-thread rows of shared memory.  The rows are stored once
//   at the end (a block's rows are contiguous, so the stores coalesce): no
//   zeroing pass and no read-modify-write in device memory.  Duval-only rows
//   wider than kStripWords words are marked a strip at a time, both passes
//   run again for each strip.
//   Flat loops.  For the CFL and ICFL bases, Duval, and the ICFL scan with its
//   border chains, are each one loop of one step an iteration, not loops
//   nested in loops: a warp whose lanes are in different phases of their
//   windows then waits for its slowest lane once per step, not at every inner
//   loop's exit.  CFL_ICFL keeps nested loops (base_pass says why).
// The block size is the one of 256, 128, 64 or 32 threads that keeps the most
// threads on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor with this
// call's shared memory), so every block is whole warps; each instance keeps
// the shape of its last call, so repeated calls make no host queries.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

enum : int { kBaseCfl = 0, kBaseIcfl = 1, kBaseCflIcfl = 2 };
constexpr int kRcThreshold = 30;
constexpr int kRegWidth = 128;      // rows up to this keep their bits in registers
constexpr int kMaxIcflWidth = 1023; // widest row of a plan with an ICFL automaton
constexpr int kStripWords = 128;    // words of a Duval-only row marked in one strip
constexpr int kMaxThreads = 256;

extern __shared__ __align__(16) uint8_t smem[];

__host__ __device__ constexpr int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

// A<->T, C<->G, any other byte 'N': the code of A C G T from bits 1-2, checked
// against its letter by a byte permute (selector nibble 4 gives a zero byte).
__device__ __forceinline__ uint32_t complement(uint32_t u) {
  const uint32_t c = ((u >> 1) & 3u) ^ ((u >> 2) & 1u);
  const uint32_t sel = 0x4440u | c;
  return u == __byte_perm(0x54474341u, 0, sel) ? __byte_perm(0x41434754u, 0, sel) : 'N';
}

// The four bytes of x complemented, in reverse order.
__device__ __forceinline__ uint32_t complement_reversed(uint32_t x) {
  return complement(x >> 24) | complement((x >> 16) & 0xFFu) << 8 |
         complement((x >> 8) & 0xFFu) << 16 | complement(x & 0xFFu) << 24;
}

// The texts an automaton reads: a staged strand (an offset into shared
// memory), the forward strand in device memory, and its reverse complement.
struct StagedText {
  int32_t off;
  __device__ __forceinline__ uint32_t operator[](int32_t x) const { return smem[off + x]; }
};

struct DeviceText {
  const uint8_t* __restrict__ s;
  __device__ __forceinline__ uint32_t operator[](int32_t x) const { return s[x]; }
};

struct DeviceRcText {
  const uint8_t* __restrict__ last;  // the window's last byte
  __device__ __forceinline__ uint32_t operator[](int32_t x) const {
    return complement(last[-x]);
  }
};

// Bits of a row of up to 128 positions in four registers; a run-time index
// picks its word by selects, which keeps the words out of local memory.
struct RegBits {
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;

  __device__ __forceinline__ void set(int32_t p) {
    const uint32_t bit = 1u << (p & 31);
    const int32_t q = p >> 5;
    w0 |= q == 0 ? bit : 0u;
    w1 |= q == 1 ? bit : 0u;
    w2 |= q == 2 ? bit : 0u;
    w3 |= q == 3 ? bit : 0u;
  }
  __device__ __forceinline__ void clear(int32_t p) {
    const uint32_t keep = ~(1u << (p & 31));
    const int32_t q = p >> 5;
    w0 &= q == 0 ? keep : ~0u;
    w1 &= q == 1 ? keep : ~0u;
    w2 &= q == 2 ? keep : ~0u;
    w3 &= q == 3 ? keep : ~0u;
  }
  // The highest set bit, or -1 (the merge clears every bit it visits, so the
  // highest one left is the next lower candidate).
  __device__ __forceinline__ int32_t highest(int32_t, int32_t) const {
    return w3 ? 127 - __clz(static_cast<int>(w3))
         : w2 ? 95 - __clz(static_cast<int>(w2))
         : w1 ? 63 - __clz(static_cast<int>(w1))
         : w0 ? 31 - __clz(static_cast<int>(w0)) : -1;
  }
};

// Bits of positions [lo, hi) of a row in one thread's row of shared memory:
// word q at words[q * stride]; lo is a multiple of 32.
struct RowBits {
  uint32_t* words;
  int32_t stride, lo, hi;

  __device__ __forceinline__ void set(int32_t p) {
    if (p >= lo && p < hi) words[((p - lo) >> 5) * stride] |= 1u << (p & 31);
  }
  __device__ __forceinline__ void clear(int32_t p) {
    words[((p - lo) >> 5) * stride] &= ~(1u << (p & 31));
  }
  // The highest set bit below `below` and at or above `floor`'s word, or -1.
  __device__ __forceinline__ int32_t highest(int32_t below, int32_t floor) const {
    for (int32_t q = (below - 1 - lo) >> 5; q >= (floor - lo) >> 5; --q) {
      const uint32_t w = words[q * stride];
      if (w) return lo + 32 * q + 31 - __clz(static_cast<int>(w));
    }
    return -1;
  }
};

// One thread's st[]: entry p at st[p * stride].
template <typename T>
struct Scratch {
  T* st;
  int32_t stride;
  __device__ __forceinline__ T& operator[](int32_t p) const { return st[p * stride]; }
};

// A factor start c of one strand: on the reverse complement a cut c marks the
// forward position n - c, and the rc start c = 0 marks nothing.
template <bool kRc, class Out>
__device__ __forceinline__ void mark(Out& out, int32_t n, int32_t c) {
  if constexpr (kRc) {
    if (c < 1) return;
    c = n - c;
  }
  out.set(c);
}

// ICFL of w[seg0, seg0 + len): marks the factor starts strictly inside it.
// Scan: the anti-order Duval scan records the border array st[base + j] = i up
// to the first ascent; chain: the bounded right extension's bound is the
// smallest border on the chain from i that precedes a character below the
// ascent's; commit: the level peels j - best characters, sets the candidate
// bit at the new base and parks best in st[old base].  Merge: candidates from
// highest to lowest, each kept iff the running first-factor length exceeds
// its level's bound st[prev].
// kFlat (the ICFL base): one scan or chain step an iteration, a level
// committing in the step that ends its chain; otherwise (CFL_ICFL, see
// base_pass) a scan loop and a chain loop per level.
template <bool kRc, bool kFlat, class Text, typename T, class Cand, class Out>
__device__ __forceinline__ void icfl_segment(const Text& w, int32_t n, int32_t seg0,
                                             int32_t len, const Scratch<T>& st, Cand& cand,
                                             Out& out) {
  int32_t base = seg0, rem = len, i = 0, j = 1, b = 0, best = 0;
  uint32_t c = 0;
  bool chain = false;
  if constexpr (!kFlat) {
    for (;;) {
      for (i = 0, j = 1; j < rem; ++j) {
        const uint32_t si = w[base + i], sj = w[base + j];
        st[base + j] = static_cast<T>(i);
        if (sj > si) {
          c = sj;
          break;
        }
        i = (sj == si) ? i + 1 : 0;
      }
      if (j >= rem) break;  // the remainder is the last factor
      for (b = best = i; b > 0;) {
        const int32_t b2 = st[base + b];
        if (w[base + b2] < c) best = b2;
        b = b2;
      }
      const int32_t plen = j - best;
      st[base] = static_cast<T>(best);
      cand.set(base + plen);
      base += plen;
      rem -= plen;
    }
  } else {
    while (chain || j < rem) {
      if (!chain) {
        const uint32_t si = w[base + i], sj = w[base + j];
        st[base + j] = static_cast<T>(i);
        if (sj > si) {
          c = sj;
          b = best = i;
          chain = true;
        } else {
          i = (sj == si) ? i + 1 : 0;
          ++j;
        }
      } else {
        const int32_t b2 = st[base + b];
        if (w[base + b2] < c) best = b2;
        b = b2;
      }
      if (chain && b <= 0) {
        const int32_t plen = j - best;
        st[base] = static_cast<T>(best);
        cand.set(base + plen);
        base += plen;
        rem -= plen;
        i = 0;
        j = 1;
        chain = false;
      }
    }
  }
  const int32_t end = seg0 + len;
  int32_t pos = cand.highest(end, seg0);
  int32_t cur = end - pos;
  while (pos > seg0) {
    cand.clear(pos);
    const int32_t below = cand.highest(pos, seg0);
    const int32_t prev = below > seg0 ? below : seg0;
    const int32_t plen = pos - prev;
    if (cur > static_cast<int32_t>(st[prev])) {
      mark<kRc>(out, n, pos);
      cur = plen;
    } else {
      cur += plen;
    }
    pos = prev;
  }
}

// One base factorization of one strand w of n characters.  Duval is one loop
// for the CFL base: a step extends the scan of the longest prefix of w[i:]
// that is a power of a Lyndon word, or emits one of its factors of length
// p = j - k (an emitting step leaves j and k as they were, so the next step
// reads the same pair again and emits again until i passes k).  CFL_ICFL
// keeps a scan loop inside an emission loop, and nested loops in each ICFL
// segment: the lanes of a warp then reach their emissions together and the
// segments of long factors run side by side; in one loop the lanes drift
// apart and the segments run one lane after another (2.3 against 0.7 ms
// for CFL_ICFL_COMB-30 at 512 000 windows of 100, one H100).
template <int kBase, bool kRc, class Text, typename T, class Cand, class Out>
__device__ __forceinline__ void base_pass(const Text& w, int32_t n, int threshold,
                                          const Scratch<T>& st, Cand& cand, Out& out) {
  if constexpr (kBase == kBaseIcfl) {
    if (n > 0) mark<kRc>(out, n, 0);
    icfl_segment<kRc, true>(w, n, 0, n, st, cand, out);
  } else if constexpr (kBase == kBaseCfl) {
    int32_t i = 0, j = 1, k = 0;
    while (i < n) {
      const bool inside = j < n;
      const uint32_t a = inside ? w[k] : 0u, c = inside ? w[j] : 0u;
      if (inside && a <= c) {
        k = (a < c) ? i : k + 1;
        ++j;
      } else {
        mark<kRc>(out, n, i);
        i += j - k;
        if (i > k) {
          j = i + 1;
          k = i;
        }
      }
    }
  } else {
    int32_t i = 0;
    while (i < n) {
      int32_t j = i + 1, k = i;
      while (j < n) {
        const uint32_t a = w[k], c = w[j];
        if (a > c) break;
        k = (a < c) ? i : k + 1;
        ++j;
      }
      const int32_t p = j - k;
      for (; i <= k; i += p) {
        mark<kRc>(out, n, i);
        if (p > threshold) icfl_segment<kRc, false>(w, n, i, p, st, cand, out);
      }
    }
  }
}

// Both strands of one window.
template <int kBase, class Fwd, class Rc, typename T, class Cand, class Out>
__device__ __forceinline__ void window_passes(const Fwd& fwd, const Rc& rc, int32_t n,
                                              int threshold, bool comb, const Scratch<T>& st,
                                              Cand& cand, Out& out) {
  base_pass<kBase, false>(fwd, n, threshold, st, cand, out);
  if (comb) {
    const int rc_threshold = kBase == kBaseCflIcfl ? kRcThreshold : threshold;
    base_pass<kBase, true>(rc, n, rc_threshold, st, cand, out);
  }
}

// What a launch shares, from the call's shape (built on the host).
struct Layout {
  int32_t cap;          // staged span bytes, a multiple of 16
  int32_t lmax;         // st[] entries a thread (ICFL plans), the call's widest window
  int32_t strip_words;  // row words in shared memory a thread (0: registers)
  int32_t cand_words;   // candidate words in shared memory a thread (ICFL plans)
};

template <typename T>
__host__ __device__ constexpr int64_t shared_bytes(const Layout& lay, int threads) {
  return 2 * int64_t{lay.cap} + align16(static_cast<int64_t>(sizeof(T)) * lay.lmax * threads) +
         4 * int64_t{lay.strip_words + lay.cand_words} * threads;
}

// kRegs: rows of up to 128 characters, bits in registers; otherwise rows of
// shared memory, marked kStripWords words at a time.  T: st[]'s entry type.
template <int kBase, bool kRegs, typename T>
__global__ void __launch_bounds__(kMaxThreads)
factor_words_kernel(const uint8_t* __restrict__ flat, int64_t n_flat,
                    const int64_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                    int64_t n_windows, int threshold, int comb, uint32_t* __restrict__ words,
                    int32_t n_words, uint8_t* __restrict__ ok, Layout lay) {
  __shared__ int64_t span_lo[kMaxThreads / 32], span_hi[kMaxThreads / 32];
  const int threads = blockDim.x, t = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * threads;
  const int64_t b = b0 + t;

  int64_t start = 0;
  int32_t n = 0;
  bool valid = false;
  if (b < n_windows) {
    start = starts[b];
    n = lengths[b];
    valid = start >= 0 && n >= 0 && start <= n_flat - n &&
            static_cast<int64_t>(n) <= 32ll * n_words && (kBase == kBaseCfl || n <= lay.lmax);
  }

  // the span of the block's windows
  int64_t lo = valid ? start : INT64_MAX, hi = valid ? start + n : -1;
  for (int d = 16; d > 0; d >>= 1) {
    const int64_t l = __shfl_xor_sync(0xFFFFFFFFu, static_cast<long long>(lo), d);
    const int64_t h = __shfl_xor_sync(0xFFFFFFFFu, static_cast<long long>(hi), d);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  if ((t & 31) == 0) {
    span_lo[t >> 5] = lo;
    span_hi[t >> 5] = hi;
  }
  __syncthreads();
  for (int w = 0; w < threads >> 5; ++w) {
    lo = span_lo[w] < lo ? span_lo[w] : lo;
    hi = span_hi[w] > hi ? span_hi[w] : hi;
  }
  const int64_t span0 = lo & ~int64_t{15};
  const int64_t staged_len = align16(hi - span0);
  const bool staged = hi >= 0 && staged_len <= lay.cap;  // uniform over the block

  if (staged) {
    // forward span at smem[0, staged_len), its reverse complement at
    // smem[cap, cap + staged_len): rc[k] = complement(fwd[staged_len - 1 - k])
    const bool aligned = (reinterpret_cast<uintptr_t>(flat) & 15) == 0;
    const int chunks = static_cast<int>(staged_len >> 4);
    for (int ch = t; ch < chunks; ch += threads) {
      const int64_t q = span0 + 16 * ch;
      uint4 v;
      if (aligned && q + 16 <= n_flat) {
        v = *reinterpret_cast<const uint4*>(flat + q);
      } else {
        uint32_t x[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16; ++i)
          if (q + i < n_flat) x[i >> 2] |= static_cast<uint32_t>(flat[q + i]) << (8 * (i & 3));
        v = make_uint4(x[0], x[1], x[2], x[3]);
      }
      *reinterpret_cast<uint4*>(smem + 16 * ch) = v;
      *reinterpret_cast<uint4*>(smem + lay.cap + staged_len - 16 - 16 * ch) =
          make_uint4(complement_reversed(v.w), complement_reversed(v.z),
                     complement_reversed(v.y), complement_reversed(v.x));
    }
    __syncthreads();
  }

  const int64_t st_off = 2 * int64_t{lay.cap};
  const Scratch<T> st{reinterpret_cast<T*>(smem + st_off) + t, threads};
  uint32_t* const rows = reinterpret_cast<uint32_t*>(
      smem + st_off + align16(static_cast<int64_t>(sizeof(T)) * lay.lmax * threads));

  // Both strands of this thread's window, from shared memory or device memory.
  auto passes = [&](auto& cand, auto& out) {
    if (!valid) return;
    if (staged) {
      const int32_t off = static_cast<int32_t>(start - span0);
      window_passes<kBase>(StagedText{off},
                           StagedText{lay.cap + static_cast<int32_t>(staged_len) - off - n}, n,
                           threshold, comb, st, cand, out);
    } else {
      window_passes<kBase>(DeviceText{flat + start}, DeviceRcText{flat + start + n - 1}, n,
                           threshold, comb, st, cand, out);
    }
  };

  if constexpr (kRegs) {
    RegBits out, cand;
    passes(cand, out);
    if (b < n_windows) {
      uint32_t* row = words + b * n_words;
      if (n_words == 4 && (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
        *reinterpret_cast<uint4*>(row) = make_uint4(out.w0, out.w1, out.w2, out.w3);
      } else {
        const uint32_t w[4] = {out.w0, out.w1, out.w2, out.w3};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < n_words) row[q] = w[q];
      }
    }
  } else {
    // rows[q * threads + t]: word q of this thread's strip; candidates after it
    const int32_t sw = lay.strip_words;
    for (int32_t q = 0; q < sw + lay.cand_words; ++q) rows[q * threads + t] = 0;
    RowBits cand{rows + sw * threads + t, threads, 0, 32 * lay.cand_words};
    for (int32_t w0 = 0; w0 < n_words; w0 += sw) {
      RowBits out{rows + t, threads, 32 * w0, 32 * (w0 + sw)};
      passes(cand, out);
      __syncthreads();
      // the block's rows are contiguous in `words`: store them word by word
      const int32_t width = sw < n_words - w0 ? sw : n_words - w0;
      const int64_t total = int64_t{threads} * width;
      for (int64_t idx = t; idx < total; idx += threads) {
        const int32_t r = static_cast<int32_t>(idx / width), q = static_cast<int32_t>(idx % width);
        if (b0 + r < n_windows) words[(b0 + r) * n_words + w0 + q] = rows[q * threads + r];
      }
      __syncthreads();
      for (int32_t q = 0; q < sw; ++q) rows[q * threads + t] = 0;
    }
  }
  if (b < n_windows) ok[b] = valid ? 1 : 0;
}

// A launch shape: the block size and the layout of its shared memory.
struct Shape {
  int device = -1;
  int32_t max_len = -1, n_words = -1;
  int threads = 0;
  Layout lay{};
};

// The block size with the most threads resident an SM, and its layout, for
// the call's widest window on `device`; also raises the instance's dynamic
// shared-memory limit to the card's opt-in limit less its static shared memory.
template <int kBase, bool kRegs, typename T>
cudaError_t find_shape(int device, int32_t max_len, int32_t n_words, Shape* out) {
  auto kernel = factor_words_kernel<kBase, kRegs, T>;
  int optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  optin -= static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;

  const bool icfl = kBase != kBaseCfl;
  const int32_t width = max_len < 1024 ? max_len : 1024;
  int best_active = 0;
  Shape best{device, max_len, n_words};
  for (int threads = kMaxThreads; threads >= 32; threads >>= 1) {
    const Layout lay{static_cast<int32_t>(align16(2 * threads + 2 * width) + 16),
                     icfl ? max_len : 0,
                     kRegs ? 0 : (n_words < kStripWords ? n_words : kStripWords),
                     icfl && !kRegs ? n_words : 0};
    const int64_t bytes = shared_bytes<T>(lay, threads);
    if (bytes > optin) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        static_cast<size_t>(bytes));
    if (err != cudaSuccess) return err;
    if (blocks * threads > best_active) {
      best_active = blocks * threads;
      best.threads = threads;
      best.lay = lay;
    }
  }
  if (best.threads == 0) return cudaErrorInvalidValue;
  *out = best;
  return cudaSuccess;
}

template <int kBase, bool kRegs, typename T>
int launch(const void* flat, int64_t n_flat, const void* starts, const void* lengths,
           int64_t n_windows, int threshold, int comb, int32_t max_len, void* words,
           int32_t n_words, void* ok, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the shape depends only on the card, the widest window and the row width:
  // each instance keeps its last one, so repeated calls make no host queries
  static std::mutex mu;
  static Shape kept;
  Shape shape;
  {
    const std::lock_guard<std::mutex> lock(mu);
    shape = kept;
  }
  if (shape.device != device || shape.max_len != max_len || shape.n_words != n_words) {
    err = find_shape<kBase, kRegs, T>(device, max_len, n_words, &shape);
    if (err != cudaSuccess) return static_cast<int>(err);
    const std::lock_guard<std::mutex> lock(mu);
    kept = shape;
  }
  const int64_t blocks = (n_windows + shape.threads - 1) / shape.threads;
  factor_words_kernel<kBase, kRegs, T>
      <<<static_cast<unsigned int>(blocks), shape.threads,
         static_cast<size_t>(shared_bytes<T>(shape.lay, shape.threads)), stream>>>(
          static_cast<const uint8_t*>(flat), n_flat, static_cast<const int64_t*>(starts),
          static_cast<const int32_t*>(lengths), n_windows, threshold, comb,
          static_cast<uint32_t*>(words), n_words, static_cast<uint8_t*>(ok), shape.lay);
  return static_cast<int>(cudaGetLastError());
}

template <int kBase>
int launch_base(const void* flat, int64_t n_flat, const void* starts, const void* lengths,
                int64_t n_windows, int threshold, int comb, int32_t max_len, void* words,
                int32_t n_words, void* ok, cudaStream_t stream) {
  if (max_len <= kRegWidth && n_words <= 4)
    return launch<kBase, true, uint8_t>(flat, n_flat, starts, lengths, n_windows, threshold,
                                         comb, max_len, words, n_words, ok, stream);
  if (kBase == kBaseCfl || max_len <= 255)
    return launch<kBase, false, uint8_t>(flat, n_flat, starts, lengths, n_windows, threshold,
                                          comb, max_len, words, n_words, ok, stream);
  return launch<kBase, false, uint16_t>(flat, n_flat, starts, lengths, n_windows, threshold,
                                         comb, max_len, words, n_words, ok, stream);
}

}  // namespace

// base: 0 cfl, 1 icfl, 2 cfl_icfl; max_len: the longest window of the call,
// which sizes the scratch and picks the instance (ICFL plans: at most 1023).
extern "C" int fpmash_factor_words(const void* flat, int64_t n_flat, const void* starts,
                                   const void* lengths, int64_t n_windows, int32_t base,
                                   int32_t threshold, int32_t comb, int32_t max_len,
                                   void* words, int32_t n_words, void* ok, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  if (n_words < 1 || max_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (base == kBaseCfl)
    return launch_base<kBaseCfl>(flat, n_flat, starts, lengths, n_windows, threshold, comb,
                                 max_len, words, n_words, ok, s);
  if (max_len > kMaxIcflWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (base == kBaseIcfl)
    return launch_base<kBaseIcfl>(flat, n_flat, starts, lengths, n_windows, threshold, comb,
                                  max_len, words, n_words, ok, s);
  if (base == kBaseCflIcfl)
    return launch_base<kBaseCflIcfl>(flat, n_flat, starts, lengths, n_windows, threshold, comb,
                                     max_len, words, n_words, ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
