// Canonical k-mer MurmurHash3 kernels of the classic sketch: K5-K8, K10, K11 and K12.
//
// Replace the Pallas kernels of fpmash_tpu/ops/kmers_pallas.py, which share
// one hash body (_canonical_murmur_body):
//   kmer_hashes_kernel<32>     _packed_slab_kernel (:510, K7; 16 < k <= 32)
//   kmer_hashes_kernel<16>     _slab_kernel (:411, K8; k <= 16)
//   kmer_masked_kernel         _packed_slab_masked_kernel (:544, K6)
//   kmer_topk8_kernel          _packed_slab_topk8r_kernel (:762, K5)
//   kmer_topk_groups_kernel    _packed_slab_topk_kernel (:619, K10)
//   canonical_murmur_kernel    _kernel (:142, K11)
//   kmer_hashes_kernel<16|32>  _fused_kernel (:225, K12), over the code stream
//                              that wraps as the TPU layout does
// K5-K8 are routed in the JAX package; K10, K11 and K12 are its older
// formulations, reached only through their own entry points.
//
// Two __device__ parts make every kernel:
//   load_window     builds the big-endian 2-bit window F, its packed reverse
//                   complement R (complement c ^ 3 at bit 2j) and the window's
//                   validity from a stream of 2-bit codes, where a code of 4 or
//                   more is invalid and packs as code & 3.  Three streams feed
//                   it: the byte stream (a-z folded to upper case unless
//                   preserve case, A C G T -> 0-3, any other byte and any
//                   position past the end -> 4), the code stream (positions
//                   past the end -> 4) and the wrapped code stream of K12.
//   canonical_hash  takes min(F, R) as unsigned 64-bit values unless
//                   noncanonical, rebuilds the ASCII bytes of bits [0, 2k) as
//                   little-endian words and runs MurmurHash3_x64_128 over the
//                   k bytes, keeping h1.
// The TPU kernels took pre-packed 16-code planes built by XLA ladders (and an
// XLA pass that turned bytes into codes); those passes are folded into the
// load.  Every shift is by less than the operand's width (F and R are built 2
// bits at a time, bytes placed at 8 (j & 7) < 64), so k = 32 needs no guard.
//
// Planes: h1's low and high 32 bits as u32 (the TPU kernels' output layout);
// the wrappers keep them in int32 tensors.  A dropped lane holds 0xFFFFFFFF
// on both planes, and a survivor equal to that pair counts as a pad, as in the
// JAX package.
//
// What bounds it on the card: the arithmetic, about 300 integer operations per
// position at k = 21 (the packing loop, the byte rebuild and five 64-bit
// multiplies); the k loads per position overlap those of the neighbouring
// threads and come from L1.  One thread per position (K10: per group);
// keeping a block's span of the stream in shared memory and rolling F and R
// along it are left for later.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kGroup = 128;  // K5: positions per group
constexpr int kKeep = 8;     // K5, K10: survivors kept per group
constexpr int kFlagNoncanonical = 1;
constexpr int kFlagPreserveCase = 2;
// K10 and K12: the TPU layout, rows of kRowBlock positions in blocks of
// kGroups rows (kmers_pallas.py ROW_BLOCK and GROUPS)
constexpr int64_t kRowBlock = 2048;
constexpr int kGroups = 8;
constexpr int64_t kBlock = kRowBlock * kGroups;
constexpr int kTopkWidth = 128;  // K10: groups per block (W_TOPK)

// The streams are built inside each kernel from its __restrict__ pointer
// parameter: K5-K8 ran as fast as with the loads written in place, while a
// stream passed as a struct parameter made them about 2 % slower, and __ldg
// loads 6-8 % slower (kernel_ab.py, one H100).  Each stream takes (data, n,
// np, flags) and gives the code at any position q >= 0.

// The byte stream: K5-K8.
struct ByteStream {
  using Elem = uint8_t;
  const uint8_t* seq;
  int64_t n;
  bool preserve_case;

  __device__ ByteStream(const uint8_t* data, int64_t n_, int64_t, int flags)
      : seq(data), n(n_), preserve_case((flags & kFlagPreserveCase) != 0) {}

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    if (q >= n) return 4u;
    uint8_t b = seq[q];
    if (!preserve_case && b >= 'a' && b <= 'z') b -= 32;
    switch (b) {
      case 'A': return 0;
      case 'C': return 1;
      case 'G': return 2;
      case 'T': return 3;
      default: return 4;
    }
  }
};

// The code stream: K10 (codes as u32, positions past the end are 4).
struct CodeStream {
  using Elem = uint32_t;
  const uint32_t* codes;
  int64_t n;

  __device__ CodeStream(const uint32_t* data, int64_t n_, int64_t, int) : codes(data), n(n_) {}

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    return q < n ? codes[q] : 4u;
  }
};

// K12's stream: the codes padded with 4 up to np (a multiple of kBlock), then
// the padded stream again from its start.  The TPU kernel gave each row of
// 2 048 the next row's first 128 codes as its halo, and the last row the first
// row's, so a window running past np reads the stream's head.
struct WrappedCodeStream {
  using Elem = uint32_t;
  const uint32_t* codes;
  int64_t n, np;

  __device__ WrappedCodeStream(const uint32_t* data, int64_t n_, int64_t np_, int)
      : codes(data), n(n_), np(np_) {}

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    if (q >= np) q -= np;
    return q < n ? codes[q] : 4u;
  }
};

// F, R and validity of the window of k <= MaxK <= 32 codes at position p.
template <int MaxK, class Stream>
__device__ __forceinline__ bool load_window(const Stream& stream, int64_t p, int k,
                                            uint64_t* F, uint64_t* R) {
  uint64_t f = 0, r = 0;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < MaxK; ++j) {
    if (j < k) {
      const uint32_t code = stream(p + j);
      ok &= code < 4;
      const uint64_t c = code & 3u;
      f = (f << 2) | c;
      r |= (c ^ 3u) << (2 * j);
    }
  }
  *F = f;
  *R = r;
  return ok;
}

// h1 of the canonical pick of (F, R): R only when R < F as unsigned 64-bit
// values (the TPU kernel compares the full pairs); only bits [0, 2k) are read.
template <int MaxK>
__device__ __forceinline__ uint64_t canonical_hash(uint64_t F, uint64_t R, int k, int flags,
                                                   uint64_t seed) {
  const uint64_t P = ((flags & kFlagNoncanonical) || !(R < F)) ? F : R;

  // ASCII bytes of P: byte j holds the code at bit 2 (k - 1 - j)
  uint64_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
  for (int j = 0; j < MaxK; ++j) {
    if (j < k) {
      const uint64_t d = (P >> (2 * (k - 1 - j))) & 3u;
      const uint64_t d1 = d >> 1;
      const uint64_t b = (65u + 2u * d + 2u * d1 + 11u * (d & d1)) << (8 * (j & 7));
      if (j < 8) w0 |= b;
      else if (j < 16) w1 |= b;
      else if (j < 24) w2 |= b;
      else w3 |= b;
    }
  }

  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k >> 4;
  const int tail = k & 15;
  if (nblocks >= 1) fpmash::murmur_block(h1, h2, w0, w1);
  if (nblocks >= 2) fpmash::murmur_block(h1, h2, w2, w3);
  if (tail > 8) h2 ^= fpmash::mix_k2(nblocks == 0 ? w1 : w3);
  if (tail > 0) h1 ^= fpmash::mix_k1(nblocks == 0 ? w0 : w2);
  fpmash::murmur_finish(h1, h2, static_cast<uint64_t>(k));
  return h1;
}

// h1 of the canonical k-mer at position p; *valid is true iff its k codes are
// all below 4.
template <int MaxK, class Stream>
__device__ __forceinline__ uint64_t window_hash(const Stream& stream, int64_t p, int k, int flags,
                                                uint64_t seed, bool* valid) {
  uint64_t F, R;
  *valid = load_window<MaxK>(stream, p, k, &F, &R);
  return canonical_hash<MaxK>(F, R, k, flags, seed);
}

// K7/K8 (byte stream) and K12 (wrapped code stream): unmasked planes and
// window validity.
template <int MaxK, class Stream>
__global__ void kmer_hashes_kernel(const typename Stream::Elem* __restrict__ data, int64_t n,
                                   int64_t np, int k, int flags, uint64_t seed,
                                   uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                                   uint8_t* __restrict__ valid) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Stream stream(data, n, np, flags);
  bool ok;
  const uint64_t h = window_hash<MaxK>(stream, p, k, flags, seed, &ok);
  lo[p] = static_cast<uint32_t>(h);
  hi[p] = static_cast<uint32_t>(h >> 32);
  valid[p] = ok;
}

// Whether the window at p is kept: valid, starting at or before length - k,
// its high word at or below t_hi, and not equal to the pad pair.
__device__ __forceinline__ bool survives(uint64_t h, bool ok, int64_t p, int64_t length, int k,
                                         uint32_t t_hi) {
  return ok && p <= length - k && static_cast<uint32_t>(h >> 32) <= t_hi && h != ~0ull;
}

// K6: planes with every dropped lane set to the pad on both planes.
__global__ void kmer_masked_kernel(const uint8_t* __restrict__ seq, int64_t n, int64_t length,
                                   int k, int flags, uint64_t seed, uint32_t t_hi,
                                   uint32_t* __restrict__ lo, uint32_t* __restrict__ hi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const ByteStream stream(seq, n, 0, flags);
  bool ok;
  const uint64_t h = window_hash<32>(stream, p, k, flags, seed, &ok);
  const bool keep = survives(h, ok, p, length, k, t_hi);
  lo[p] = keep ? static_cast<uint32_t>(h) : kPad;
  hi[p] = keep ? static_cast<uint32_t>(h >> 32) : kPad;
}

// K5: one warp per group of 128 consecutive positions (group g holds
// positions 128 g .. 128 g + 127).  Lane l hashes positions 128 g + 32 i + l,
// i = 0..3; a ballot per i compacts the survivors, duplicates kept, into the
// warp's slice of shared memory.  Each survivor's rank is the number that sort
// before it by (value, slot); ranks 0-7 are written ascending to slots
// 8 g .. 8 g + 7, and slots beyond the survivor count get the pad.  A group of
// more than 8 survivors sets *overflow.  The TPU kernel's lane-strided groups
// (lane mod 128 of an 8 x 2048 block) and sorting networks are not carried
// over: K10 below keeps them.
__global__ void kmer_topk8_kernel(const uint8_t* __restrict__ seq, int64_t n, int64_t length,
                                  int k, int flags, uint64_t seed, uint32_t t_hi,
                                  int64_t n_groups, uint32_t* __restrict__ clo,
                                  uint32_t* __restrict__ chi, int32_t* __restrict__ overflow) {
  __shared__ uint64_t survivors[kThreads / 32][kGroup];
  const ByteStream stream(seq, n, 0, flags);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
  if (g >= n_groups) return;  // the whole warp leaves together
  uint64_t* slot = survivors[warp];

  int count = 0;
#pragma unroll
  for (int i = 0; i < kGroup / 32; ++i) {
    const int64_t p = g * kGroup + 32 * i + lane;
    bool keep = false;
    uint64_t h = 0;
    if (p < n) {
      bool ok;
      h = window_hash<32>(stream, p, k, flags, seed, &ok);
      keep = survives(h, ok, p, length, k, t_hi);
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) slot[count + __popc(ballot & ((1u << lane) - 1u))] = h;
    count += __popc(ballot);
  }
  __syncwarp();

  for (int a = lane; a < count; a += 32) {
    const uint64_t v = slot[a];
    int rank = 0;
    for (int b = 0; b < count; ++b) {
      const uint64_t u = slot[b];
      rank += (u < v) || (u == v && b < a);
    }
    if (rank < kKeep) {
      clo[g * kKeep + rank] = static_cast<uint32_t>(v);
      chi[g * kKeep + rank] = static_cast<uint32_t>(v >> 32);
    }
  }
  if (lane >= count && lane < kKeep) {
    clo[g * kKeep + lane] = kPad;
    chi[g * kKeep + lane] = kPad;
  }
  if (lane == 0 && count > kKeep) *overflow = 1;
}

// K10: the TPU kernel's own groups, one thread per group.  Block c of 16 384
// positions has 128 groups; group j holds positions
// 16384 c + 2048 s + j + 128 m (s < 8, m < 16), the lanes that the TPU
// kernel's halving folds (kmers_pallas.py:681-700) bring to column j, so
// neighbouring threads read neighbouring positions.  The thread keeps the 8
// smallest survivors by unsigned value in a sorted list in registers (every
// index is static: each step moves an entry down or takes the new value),
// duplicates kept, and writes rank i to slot 1024 c + 128 i + j; unused ranks
// keep the pad.  More than 8 survivors set *overflow.  Unlike K5's warp
// ballots and ranks, nothing is shared between threads, so the two kernels
// check each other.
__global__ void kmer_topk_groups_kernel(const uint32_t* __restrict__ codes, int64_t n,
                                        int64_t length, int k, int flags, uint64_t seed,
                                        uint32_t t_hi, uint32_t* __restrict__ clo,
                                        uint32_t* __restrict__ chi,
                                        int32_t* __restrict__ overflow) {
  const CodeStream stream(codes, n, 0, flags);
  const int64_t c = blockIdx.x;
  const int j = threadIdx.x;
  uint64_t best[kKeep];
#pragma unroll
  for (int i = 0; i < kKeep; ++i) best[i] = ~0ull;
  int count = 0;
  for (int s = 0; s < kGroups; ++s) {
    for (int m = 0; m < kRowBlock / kTopkWidth; ++m) {
      const int64_t p = kBlock * c + kRowBlock * s + j + kTopkWidth * m;
      bool ok;
      const uint64_t h = window_hash<32>(stream, p, k, flags, seed, &ok);
      if (!survives(h, ok, p, length, k, t_hi)) continue;
      ++count;
#pragma unroll
      for (int i = kKeep - 1; i > 0; --i) {
        best[i] = h < best[i - 1] ? best[i - 1] : (h < best[i] ? h : best[i]);
      }
      best[0] = h < best[0] ? h : best[0];
    }
  }
#pragma unroll
  for (int i = 0; i < kKeep; ++i) {
    const int64_t slot = kKeep * kTopkWidth * c + kTopkWidth * i + j;
    clo[slot] = static_cast<uint32_t>(best[i]);
    chi[slot] = static_cast<uint32_t>(best[i] >> 32);
  }
  if (count > kKeep) *overflow = 1;
}

// K11: h1 of the canonical pick of given F and R (R is not read when
// noncanonical).
__global__ void canonical_murmur_kernel(const uint64_t* __restrict__ F,
                                        const uint64_t* __restrict__ R, int64_t n, int k,
                                        int flags, uint64_t seed, uint64_t* __restrict__ h1) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint64_t f = F[p];
  const uint64_t r = (flags & kFlagNoncanonical) ? f : R[p];
  h1[p] = canonical_hash<32>(f, r, k, flags, seed);
}

unsigned int blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned int>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" int fpmash_kmer_hashes(const void* seq, int64_t n, int32_t k, int32_t flags,
                                  uint64_t seed, void* lo, void* hi, void* valid, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(seq);
  auto* out_lo = static_cast<uint32_t*>(lo);
  auto* out_hi = static_cast<uint32_t*>(hi);
  auto* out_valid = static_cast<uint8_t*>(valid);
  if (k <= 16) {
    kmer_hashes_kernel<16, ByteStream><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, 0, k, flags, seed, out_lo, out_hi, out_valid);
  } else {
    kmer_hashes_kernel<32, ByteStream><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, 0, k, flags, seed, out_lo, out_hi, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_kmer_hashes_masked(const void* seq, int64_t n, int64_t length, int32_t k,
                                         int32_t flags, uint64_t seed, uint32_t t_hi, void* lo,
                                         void* hi, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  kmer_masked_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, length, k, flags, seed, t_hi,
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_kmer_hashes_topk8(const void* seq, int64_t n, int64_t length, int32_t k,
                                        int32_t flags, uint64_t seed, uint32_t t_hi, void* clo,
                                        void* chi, void* overflow, void* stream) {
  const int64_t n_groups = (n + kGroup - 1) / kGroup;
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
  kmer_topk8_kernel<<<blocks_for(n_groups, kThreads / 32), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, length, k, flags, seed, t_hi, n_groups,
      static_cast<uint32_t*>(clo), static_cast<uint32_t*>(chi),
      static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// K10 over codes[0, n): planes of 1 024 slots for each of the ceil(n / 16384)
// blocks.
extern "C" int fpmash_kmer_codes_topk(const void* codes, int64_t n, int64_t length, int32_t k,
                                      int32_t flags, uint64_t seed, uint32_t t_hi, void* clo,
                                      void* chi, void* overflow, void* stream) {
  const int64_t n_blocks = (n + kBlock - 1) / kBlock;
  if (n_blocks <= 0) return static_cast<int>(cudaSuccess);
  kmer_topk_groups_kernel<<<static_cast<unsigned int>(n_blocks), kTopkWidth, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), n, length, k, flags, seed, t_hi,
      static_cast<uint32_t*>(clo), static_cast<uint32_t*>(chi),
      static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// K12 over codes[0, n), reading past the end as the TPU layout does (see
// WrappedCodeStream).
extern "C" int fpmash_kmer_codes_hashes(const void* codes, int64_t n, int32_t k, int32_t flags,
                                        uint64_t seed, void* lo, void* hi, void* valid,
                                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(codes);
  const int64_t np = (n + kBlock - 1) / kBlock * kBlock;
  auto* out_lo = static_cast<uint32_t*>(lo);
  auto* out_hi = static_cast<uint32_t*>(hi);
  auto* out_valid = static_cast<uint8_t*>(valid);
  if (k <= 16) {
    kmer_hashes_kernel<16, WrappedCodeStream><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, np, k, flags, seed, out_lo, out_hi, out_valid);
  } else {
    kmer_hashes_kernel<32, WrappedCodeStream><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, np, k, flags, seed, out_lo, out_hi, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_canonical_murmur(const void* F, const void* R, int64_t n, int32_t k,
                                       int32_t flags, uint64_t seed, void* h1, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  canonical_murmur_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(F), static_cast<const uint64_t*>(R), n, k, flags, seed,
      static_cast<uint64_t*>(h1));
  return static_cast<int>(cudaGetLastError());
}
