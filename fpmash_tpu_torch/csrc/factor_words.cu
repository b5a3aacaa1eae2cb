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
// stream, or is wider than the instance's LMAX, gets zero words and ok 0.
//
// Design.  Duval's i/j/k loop runs in registers (fingerprint.cu without the
// hash).  The ICFL automaton is the reference recursion made iterative, as in
// ops/icfl.py: an anti-order Duval scan that records the border array
// st[j] = i, a walk down the border chain at the first ascent, one level
// record (boundary position, bound `last`) per peeled prefix, then a backward
// fold over the levels that keeps a boundary iff the running first-factor
// length exceeds its bound.  st[] and the level records are indexed at run
// time, so they live in shared memory (a thread-local array would go to local
// memory), laid out position-major (entry p of thread t at p * THREADS + t) so
// that a warp's threads reading the same position hit distinct banks.  There
// is no level cap and no step cap: a segment of length m has fewer than m
// levels, so every row fits, and every loop ends on its own.  The TPU
// kernel's select tree over packed words and its parking of `last` in dead
// st[] slots existed for 8x128 vector lanes and are not carried over.
//
// Instances: Duval-only plans (CFL, CFL_COMB) need no scratch and take rows
// of any width; ICFL plans take rows up to 128 (uint8 scratch, 64 threads a
// block, 24 KB) or up to 1023 (uint16 scratch, 8 threads a block, 48 KB), the
// JAX package's device bound.  Wider rows go to the scalar model upstream.
//
// What bounds it on the card: the serial automatons (about 2-4 steps per
// character per pass, two passes for COMB), warp divergence between windows,
// and shared-memory occupancy for the ICFL instances; the boundary bits are
// read-modify-writes of the thread's own row in device memory, through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int { kBaseCfl = 0, kBaseIcfl = 1, kBaseCflIcfl = 2 };
constexpr int kRcThreshold = 30;

// One window as the automatons read it: forward, or its reverse complement.
struct Window {
  const uint8_t* __restrict__ s;
  int32_t n;
  bool rc;

  __device__ __forceinline__ uint8_t operator[](int32_t x) const {
    if (!rc) return s[x];
    switch (s[n - 1 - x]) {
      case 'A': return 'T';
      case 'C': return 'G';
      case 'G': return 'C';
      case 'T': return 'A';
      default: return 'N';
    }
  }
};

// The row's factor-start bits.  On the reverse complement a cut c marks the
// forward position n - c, and the rc start c = 0 marks nothing.
struct Bits {
  uint32_t* __restrict__ row;
  int32_t n;
  bool rc;

  __device__ __forceinline__ void mark(int32_t c) const {
    if (rc) {
      if (c < 1) return;
      c = n - c;
    }
    row[c >> 5] |= 1u << (c & 31);
  }
};

// One thread's ICFL scratch in shared memory: st[] and the level records.
template <typename T, int THREADS>
struct Scratch {
  T* st;
  T* lev_pos;
  T* lev_last;

  __device__ __forceinline__ T& at(T* a, int32_t p) const { return a[p * THREADS]; }
};

// ICFL of w[seg0, seg0 + len): marks the factor starts strictly inside it.
template <typename T, int THREADS>
__device__ void icfl_segment(const Window& w, int32_t seg0, int32_t len,
                             const Scratch<T, THREADS>& sc, const Bits& bits) {
  int32_t base = seg0, rem = len, nlev = 0;
  for (;;) {
    // anti-order Duval scan of w[base, base + rem) up to its first ascent
    int32_t i = 0, j = 1;
    uint8_t c = 0;
    for (; j < rem; ++j) {
      const uint8_t si = w[base + i], sj = w[base + j];
      sc.at(sc.st, j) = static_cast<T>(i);
      if (sj > si) {
        c = sj;
        break;
      }
      i = (sj == si) ? i + 1 : 0;
    }
    if (j >= rem) break;  // the remainder is the last factor
    // bounded right extension: the smallest border on the chain from i
    // that precedes a character below the ascent's
    int32_t best = i;
    for (int32_t b = i; b > 0;) {
      const int32_t b2 = sc.at(sc.st, b);
      if (w[base + b2] < c) best = b2;
      b = b2;
    }
    const int32_t plen = j - best;
    sc.at(sc.lev_pos, nlev) = static_cast<T>(base + plen);
    sc.at(sc.lev_last, nlev) = static_cast<T>(best);
    ++nlev;
    base += plen;
    rem -= plen;
  }
  // fold the levels backward from the last factor
  int32_t cur = rem;
  for (int32_t m = nlev - 1; m >= 0; --m) {
    const int32_t pos = sc.at(sc.lev_pos, m);
    const int32_t plen = pos - (m > 0 ? static_cast<int32_t>(sc.at(sc.lev_pos, m - 1)) : seg0);
    if (cur > static_cast<int32_t>(sc.at(sc.lev_last, m))) {
      bits.mark(pos);
      cur = plen;
    } else {
      cur += plen;
    }
  }
}

// One base factorization of w, its starts marked through `bits`.
template <int LMAX, typename T, int THREADS>
__device__ void base_pass(int base, int threshold, const Window& w, const Bits& bits,
                          const Scratch<T, THREADS>& sc) {
  if constexpr (LMAX > 0) {
    if (base == kBaseIcfl) {
      if (w.n > 0) bits.mark(0);
      icfl_segment(w, 0, w.n, sc, bits);
      return;
    }
  }
  int32_t i = 0;
  while (i < w.n) {
    int32_t j = i + 1, k = i;
    while (j < w.n) {
      const uint8_t a = w[k], c = w[j];
      if (a > c) break;
      k = (a < c) ? i : k + 1;
      ++j;
    }
    const int32_t p = j - k;
    while (i <= k) {
      bits.mark(i);
      if constexpr (LMAX > 0) {
        if (base == kBaseCflIcfl && p > threshold) icfl_segment(w, i, p, sc, bits);
      }
      i += p;
    }
  }
}

// LMAX == 0: Duval-only plans, rows of any width, no scratch.
template <int LMAX, typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
factor_words_kernel(const uint8_t* __restrict__ flat, int64_t n_flat,
                    const int64_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                    int64_t n_windows, int base, int threshold, int comb,
                    uint32_t* __restrict__ words, int32_t n_words, uint8_t* __restrict__ ok) {
  constexpr int kSlots = LMAX > 0 ? LMAX * THREADS : 1;
  __shared__ T st[kSlots];
  __shared__ T lev_pos[kSlots];
  __shared__ T lev_last[kSlots];

  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= n_windows) return;
  uint32_t* row = words + b * n_words;
  for (int32_t w = 0; w < n_words; ++w) row[w] = 0;
  const int64_t start = starts[b];
  const int32_t n = lengths[b];
  if (start < 0 || n < 0 || start > n_flat - n || (LMAX > 0 && n > LMAX) ||
      static_cast<int64_t>(n) > 32ll * n_words) {
    ok[b] = 0;
    return;
  }
  const Scratch<T, THREADS> sc{st + threadIdx.x, lev_pos + threadIdx.x, lev_last + threadIdx.x};
  const uint8_t* s = flat + start;
  base_pass<LMAX>(base, threshold, Window{s, n, false}, Bits{row, n, false}, sc);
  if (comb) {
    const int rc_threshold = base == kBaseCflIcfl ? kRcThreshold : threshold;
    base_pass<LMAX>(base, rc_threshold, Window{s, n, true}, Bits{row, n, true}, sc);
  }
  ok[b] = 1;
}

template <int LMAX, typename T, int THREADS>
int launch(const void* flat, int64_t n_flat, const void* starts, const void* lengths,
           int64_t n_windows, int base, int threshold, int comb, void* words,
           int32_t n_words, void* ok, void* stream) {
  const int64_t blocks = (n_windows + THREADS - 1) / THREADS;
  factor_words_kernel<LMAX, T, THREADS>
      <<<static_cast<unsigned int>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(flat), n_flat, static_cast<const int64_t*>(starts),
          static_cast<const int32_t*>(lengths), n_windows, base, threshold, comb,
          static_cast<uint32_t*>(words), n_words, static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// base: 0 cfl, 1 icfl, 2 cfl_icfl; max_len: the longest window of the call,
// which picks the instance (ICFL plans: at most 1023).
extern "C" int fpmash_factor_words(const void* flat, int64_t n_flat, const void* starts,
                                   const void* lengths, int64_t n_windows, int32_t base,
                                   int32_t threshold, int32_t comb, int32_t max_len,
                                   void* words, int32_t n_words, void* ok, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  if (base == kBaseCfl)
    return launch<0, uint8_t, 256>(flat, n_flat, starts, lengths, n_windows, base, threshold,
                                   comb, words, n_words, ok, stream);
  if (base != kBaseIcfl && base != kBaseCflIcfl) return static_cast<int>(cudaErrorInvalidValue);
  if (max_len <= 128)
    return launch<128, uint8_t, 64>(flat, n_flat, starts, lengths, n_windows, base, threshold,
                                    comb, words, n_words, ok, stream);
  if (max_len <= 1023)
    return launch<1023, uint16_t, 8>(flat, n_flat, starts, lengths, n_windows, base, threshold,
                                     comb, words, n_words, ok, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
