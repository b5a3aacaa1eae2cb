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
// The body, in three parts:
//   stage           a block reads its tile of the stream once (16-byte loads),
//                   maps each position once to a 2-bit code and an invalid
//                   flag, and keeps both packed in shared memory: the codes
//                   little-endian (position q at bits 2q), the flags one bit a
//                   position.  Three streams feed it: the byte stream (a-z
//                   folded to upper case unless preserve case, A C G T -> 0-3,
//                   any other byte and any position past the end -> 4), the
//                   code stream (positions past the end -> 4) and the wrapped
//                   code stream of K12.  A code of 4 or more is invalid and
//                   packs as code & 3.
//   staged_window   reads the window at a position in O(1): two funnel shifts
//                   give its 2k code bits `le` (code j at bits 2j), one more its
//                   k invalid flags.
//   window_hash     R, the packed reverse complement (complement c ^ 3 at bit
//                   2j), is le ^ M (M the low 2k bits); F, the big-endian
//                   window, is le with its digits reversed (a bit reversal,
//                   a swap of each bit pair, a shift).  The pick is R only
//                   when R < F as unsigned 64-bit values, unless
//                   noncanonical; its ASCII bytes in message order are the
//                   digits of le (pick F) or F ^ M (pick R), little-endian,
//                   so digits_hash spreads 8 digits to 8 bytes with two
//                   shift-masks and two byte permutes (the bytes at k and up
//                   select a zero byte) and runs MurmurHash3_x64_128 over
//                   the k bytes, keeping h1.  K11 reverses its given pick
//                   the same way (canonical_hash).
// The TPU kernels took pre-packed 16-code planes built by XLA ladders (and an
// XLA pass that turned bytes into codes); those passes are folded into the
// staging.  No shift reaches the operand's width: M is ~0 >> (64 - 2k) and the
// reversal shifts by 64 - 2k <= 62, so k = 32 needs no guard.
//
// Planes: h1's low and high 32 bits as u32 (the TPU kernels' output layout);
// the wrappers keep them in int32 tensors.  A dropped lane holds 0xFFFFFFFF
// on both planes, and a survivor equal to that pair counts as a pad, as in the
// JAX package.
//
// What bounds it on the card: the integer operations.  Per position about 10
// to stage, about 35 to read the window, reverse it and pick, about 20 to make
// the bytes, and MurmurHash3 (about 95 at k = 21: one block, one tail word,
// the closing mix) -- about 160 in all at k = 21, where the one thread a
// position that read and mapped its k bytes and rebuilt them one at a time
// issued about 450.  The stream is read once a tile (4 096 positions and a
// halo of 32; K10: its block of 16 384), so memory moves 9 bytes a position
// (K7) and stays far below the operations.  Lanes take consecutive positions:
// their shared-memory reads fall on one or two words (broadcasts) and their
// stores coalesce.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kTile = 4096;  // positions a block of K5-K8 and K12 hashes
constexpr int kGroup = 128;  // K5: positions per group
constexpr int kKeep = 8;     // K5, K10: survivors kept per group
constexpr int kFlagNoncanonical = 1;
constexpr int kFlagPreserveCase = 2;
// K10 and K12: the TPU layout, rows of kRowBlock positions in blocks of
// kGroups rows (kmers_pallas.py ROW_BLOCK and GROUPS)
constexpr int kRowBlock = 2048;
constexpr int kGroups = 8;
constexpr int kBlock = kRowBlock * kGroups;
constexpr int kTopkWidth = 128;  // K10: groups per block (W_TOPK)

// Staged positions of a tile of T: T and a halo of 32 (a window reaches 31
// past its start, and staged_window reads the word after its last), in chunks
// of 16 positions.
__host__ __device__ constexpr int staged_chunks(int tile) { return tile / 16 + 2; }

// The streams are built inside each kernel from its __restrict__ pointer
// parameter (a stream passed as a struct parameter made the kernels about
// 2 % slower, kernel_ab.py, one H100).  Each stream takes (data, n, np,
// flags), gives the code at any position q >= 0, and the 16 codes of the
// chunk at q0 (a multiple of 16), with 16-byte loads where the chunk lies
// inside the data and the data is 16-byte aligned.

// The byte stream: K5-K8.
struct ByteStream {
  using Elem = uint8_t;
  const uint8_t* seq;
  int64_t n;
  uint32_t fold;  // 0xDF folds a-z to A-Z (and no other byte to A, C, G or T)
  bool aligned;

  __device__ ByteStream(const uint8_t* data, int64_t n_, int64_t, int flags)
      : seq(data),
        n(n_),
        fold((flags & kFlagPreserveCase) ? 0xFFu : 0xDFu),
        aligned((reinterpret_cast<uintptr_t>(data) & 15) == 0) {}

  // A C G T -> 0 1 2 3 from bits 1-2 of the byte; any other byte -> 4
  // (selector 0x444c: byte c of "ACGT", then three zero bytes)
  __device__ __forceinline__ uint32_t code(uint32_t b) const {
    const uint32_t u = b & fold;
    const uint32_t c = ((u >> 1) & 3u) ^ ((u >> 2) & 1u);
    return u == __byte_perm(0x54474341u, 0, 0x4440u | c) ? c : 4u;
  }

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    return q < n ? code(seq[q]) : 4u;
  }

  __device__ __forceinline__ void chunk(int64_t q0, uint32_t (&c)[16]) const {
    if (aligned && q0 + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(seq + q0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) c[i] = code((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) c[i] = (*this)(q0 + i);
    }
  }
};

// The 16 u32 codes at q0 of a code array with n entries.
__device__ __forceinline__ bool load_codes16(const uint32_t* codes, int64_t n, bool aligned,
                                             int64_t q0, uint32_t (&c)[16]) {
  if (!aligned || q0 + 16 > n) return false;
  const uint4* v = reinterpret_cast<const uint4*>(codes + q0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 x = v[i];
    c[4 * i] = x.x;
    c[4 * i + 1] = x.y;
    c[4 * i + 2] = x.z;
    c[4 * i + 3] = x.w;
  }
  return true;
}

// The code stream: K10 (codes as u32, positions past the end are 4).
struct CodeStream {
  using Elem = uint32_t;
  const uint32_t* codes;
  int64_t n;
  bool aligned;

  __device__ CodeStream(const uint32_t* data, int64_t n_, int64_t, int)
      : codes(data), n(n_), aligned((reinterpret_cast<uintptr_t>(data) & 15) == 0) {}

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    return q < n ? codes[q] : 4u;
  }

  __device__ __forceinline__ void chunk(int64_t q0, uint32_t (&c)[16]) const {
    if (load_codes16(codes, n, aligned, q0, c)) return;
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = (*this)(q0 + i);
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
  bool aligned;

  __device__ WrappedCodeStream(const uint32_t* data, int64_t n_, int64_t np_, int)
      : codes(data), n(n_), np(np_), aligned((reinterpret_cast<uintptr_t>(data) & 15) == 0) {}

  __device__ __forceinline__ uint32_t operator()(int64_t q) const {
    if (q >= np) q -= np;
    return q < n ? codes[q] : 4u;
  }

  __device__ __forceinline__ void chunk(int64_t q0, uint32_t (&c)[16]) const {
    if (load_codes16(codes, n, aligned, q0, c)) return;  // q0 + 16 <= n < np: no wrap
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = (*this)(q0 + i);
  }
};

// Stages `chunks` (even) chunks of 16 positions from `base` into shared
// memory: packed[q >> 4] holds the code of position base + q at bits
// 2 (q & 15) (an invalid code as code & 3), bad[q >> 5] its invalid flag at
// bit q & 31.  One thread a chunk; the even lane of a pair writes the pair's
// flags.  Every thread of the block (a multiple of 32) calls it.
template <class Stream>
__device__ __forceinline__ void stage(const Stream& stream, int64_t base, int chunks,
                                      uint32_t* packed, uint32_t* bad) {
  for (int c0 = 0; c0 < chunks; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    uint32_t bits = 0, flags = 0;
    if (c < chunks) {
      uint32_t code[16];
      stream.chunk(base + 16 * c, code);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        bits |= (code[i] & 3u) << (2 * i);
        flags |= (code[i] > 3u ? 1u : 0u) << i;
      }
    }
    const uint32_t next = __shfl_down_sync(0xFFFFFFFFu, flags, 1);
    if (c < chunks) {
      packed[c] = bits;
      if (!(c & 1)) bad[c >> 1] = flags | (next << 16);
    }
  }
}

// What every window of a launch shares, from k: built on the host and passed
// by value, so its fields are uniform operands of the kernel's instructions.
struct KmerShape {
  int k;
  int flip;         // 64 - 2k: brings a bit-reversed window's digits down to bit 0
  uint64_t digits;  // M, the low 2k bits
  uint32_t codes;   // the low k bits: a window's invalid flags
  uint32_t pad[4];  // per 8-byte word, selector nibble 4 (a zero byte) at each byte >= k

  explicit KmerShape(int k_)
      : k(k_), flip(64 - 2 * k_), digits(~0ull >> (64 - 2 * k_)), codes(~0u >> (32 - k_)) {
    for (int i = 0; i < 4; ++i) {
      const int r = k_ - 8 * i;  // bytes of word i below k
      pad[i] = r >= 8 ? 0u : r <= 0 ? 0x44444444u : 0x44444444u << (4 * r);
    }
  }
};

// The 2k code bits of the window at staged position q, little-endian (the
// code of position q + j at bits 2j), and whether its k codes are valid.
template <int MaxK>
__device__ __forceinline__ uint64_t staged_window(const uint32_t* packed, const uint32_t* bad,
                                                  int q, const KmerShape& s, bool* ok) {
  const int w = q >> 4;
  const int shift = 2 * (q & 15);
  const uint32_t a = packed[w], b = packed[w + 1];
  uint64_t le = __funnelshift_r(a, b, shift);
  if constexpr (MaxK > 16) {
    le |= static_cast<uint64_t>(__funnelshift_r(b, packed[w + 2], shift)) << 32;
  }
  const int v = q >> 5;
  *ok = (__funnelshift_r(bad[v], bad[v + 1], q & 31) & s.codes) == 0;
  return le & s.digits;
}

// Swaps the two bits of every 2-bit digit.
__device__ __forceinline__ uint64_t swap_pairs(uint64_t x) {
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ uint32_t swap_pairs32(uint32_t x) {
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// The ASCII bytes (A C G T) of the 8 digits in bytes 0 and 2 of x (from a
// byte permute of the little-endian digits), with the selector nibbles of
// pad or'ed in: a byte whose nibble is 4 or more is 0.
__device__ __forceinline__ uint64_t ascii_word(uint32_t x, uint32_t pad) {
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = ((x | (x << 2)) & 0x33333333u) | pad;  // nibble i: digit i
  const uint32_t lo = __byte_perm(0x54474341u, 0, x);
  const uint32_t hi = __byte_perm(0x54474341u, 0, x >> 16);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// h1 of MurmurHash3_x64_128 over the k ASCII bytes of the little-endian
// digits L (byte j is the digit at bits 2j; L's bits above 2k are 0).
template <int MaxK>
__device__ __forceinline__ uint64_t digits_hash(uint64_t L, const KmerShape& s, uint64_t seed) {
  const uint32_t lo = static_cast<uint32_t>(L);
  const uint64_t w0 = ascii_word(__byte_perm(lo, 0, 0x4140), s.pad[0]);
  const uint64_t w1 = ascii_word(__byte_perm(lo, 0, 0x4342), s.pad[1]);
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = s.k >> 4;
  const int tail = s.k & 15;
  uint64_t t1 = w0, t2 = w1;  // the tail's words
  if (nblocks >= 1) fpmash::murmur_block(h1, h2, w0, w1);
  if constexpr (MaxK > 16) {
    const uint32_t hi = static_cast<uint32_t>(L >> 32);
    const uint64_t w2 = ascii_word(__byte_perm(hi, 0, 0x4140), s.pad[2]);
    const uint64_t w3 = ascii_word(__byte_perm(hi, 0, 0x4342), s.pad[3]);
    if (nblocks >= 2) fpmash::murmur_block(h1, h2, w2, w3);
    if (nblocks >= 1) {
      t1 = w2;
      t2 = w3;
    }
  }
  if (tail > 8) h2 ^= fpmash::mix_k2(t2);
  if (tail > 0) h1 ^= fpmash::mix_k1(t1);
  fpmash::murmur_finish(h1, h2, static_cast<uint64_t>(s.k));
  return h1;
}

// h1 of the canonical k-mer whose little-endian digits are le.
template <int MaxK>
__device__ __forceinline__ uint64_t window_hash(uint64_t le, const KmerShape& s, int flags,
                                                uint64_t seed) {
  const bool canonical = !(flags & kFlagNoncanonical);
  if constexpr (MaxK <= 16) {  // 2k <= 32: the same in 32 bits
    const uint32_t l = static_cast<uint32_t>(le), m = static_cast<uint32_t>(s.digits);
    const uint32_t F = swap_pairs32(__brev(l)) >> (s.flip - 32);
    const bool take_r = canonical && (l ^ m) < F;
    return digits_hash<MaxK>(take_r ? F ^ m : l, s, seed);
  } else {
    const uint64_t F = swap_pairs(__brevll(le)) >> s.flip;
    const bool take_r = canonical && (le ^ s.digits) < F;
    return digits_hash<MaxK>(take_r ? F ^ s.digits : le, s, seed);
  }
}

// h1 of the canonical pick of (F, R): R only when R < F as unsigned 64-bit
// values (the TPU kernel compares the full pairs); only bits [0, 2k) are read.
__device__ __forceinline__ uint64_t canonical_hash(uint64_t F, uint64_t R, const KmerShape& s,
                                                   int flags, uint64_t seed) {
  const uint64_t P = ((flags & kFlagNoncanonical) || !(R < F)) ? F : R;
  return digits_hash<32>(swap_pairs(__brevll(P)) >> s.flip, s, seed);
}

// K7/K8 (byte stream) and K12 (wrapped code stream): unmasked planes and
// window validity of the block's tile.
template <int MaxK, class Stream>
__global__ void __launch_bounds__(kThreads)
    kmer_hashes_kernel(const typename Stream::Elem* __restrict__ data, int64_t n, int64_t np,
                       KmerShape shape, int flags, uint64_t seed, uint32_t* __restrict__ lo,
                       uint32_t* __restrict__ hi, uint8_t* __restrict__ valid) {
  __shared__ uint32_t packed[staged_chunks(kTile)];
  __shared__ uint32_t bad[staged_chunks(kTile) / 2];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  stage(Stream(data, n, np, flags), base, staged_chunks(kTile), packed, bad);
  __syncthreads();
  for (int q = threadIdx.x; q < kTile && base + q < n; q += kThreads) {
    const int64_t p = base + q;
    bool ok;
    const uint64_t h = window_hash<MaxK>(staged_window<MaxK>(packed, bad, q, shape, &ok), shape,
                                         flags, seed);
    lo[p] = static_cast<uint32_t>(h);
    hi[p] = static_cast<uint32_t>(h >> 32);
    valid[p] = ok;
  }
}

// Whether the window at p is kept: valid, starting at or before length - k,
// its high word at or below t_hi, and not equal to the pad pair.
__device__ __forceinline__ bool survives(uint64_t h, bool ok, int64_t p, int64_t length, int k,
                                         uint32_t t_hi) {
  return ok && p <= length - k && static_cast<uint32_t>(h >> 32) <= t_hi && h != ~0ull;
}

// K6: planes with every dropped lane set to the pad on both planes.
__global__ void __launch_bounds__(kThreads)
    kmer_masked_kernel(const uint8_t* __restrict__ seq, int64_t n, int64_t length,
                       KmerShape shape, int flags, uint64_t seed, uint32_t t_hi,
                       uint32_t* __restrict__ lo, uint32_t* __restrict__ hi) {
  __shared__ uint32_t packed[staged_chunks(kTile)];
  __shared__ uint32_t bad[staged_chunks(kTile) / 2];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  stage(ByteStream(seq, n, 0, flags), base, staged_chunks(kTile), packed, bad);
  __syncthreads();
  for (int q = threadIdx.x; q < kTile && base + q < n; q += kThreads) {
    const int64_t p = base + q;
    bool ok;
    const uint64_t h = window_hash<32>(staged_window<32>(packed, bad, q, shape, &ok), shape,
                                       flags, seed);
    const bool keep = survives(h, ok, p, length, shape.k, t_hi);
    lo[p] = keep ? static_cast<uint32_t>(h) : kPad;
    hi[p] = keep ? static_cast<uint32_t>(h >> 32) : kPad;
  }
}

// K5: one warp per group of 128 consecutive positions (group g holds
// positions 128 g .. 128 g + 127), each warp 4 of the tile's 32 groups in
// turn.  Lane l hashes positions 128 g + 32 i + l, i = 0..3; a ballot per i
// compacts the survivors, duplicates kept, into the warp's slice of shared
// memory.  Each survivor's rank is the number that sort before it by (value,
// slot); equal values are equal planes, so the output does not depend on the
// slot order.  Ranks 0-7 are written ascending to slots 8 g .. 8 g + 7, and
// slots beyond the survivor count get the pad.  A group of more than 8
// survivors sets *overflow.  The TPU kernel's lane-strided groups (lane mod
// 128 of an 8 x 2048 block) and sorting networks are not carried over: K10
// below keeps them.
__global__ void __launch_bounds__(kThreads)
    kmer_topk8_kernel(const uint8_t* __restrict__ seq, int64_t n, int64_t length,
                      KmerShape shape, int flags, uint64_t seed, uint32_t t_hi, int64_t n_groups,
                      uint32_t* __restrict__ clo, uint32_t* __restrict__ chi,
                      int32_t* __restrict__ overflow) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kWarpGroups = kTile / kGroup / kWarps;
  __shared__ uint32_t packed[staged_chunks(kTile)];
  __shared__ uint32_t bad[staged_chunks(kTile) / 2];
  __shared__ uint64_t survivors[kWarps][kGroup];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  stage(ByteStream(seq, n, 0, flags), base, staged_chunks(kTile), packed, bad);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* slot = survivors[warp];

  for (int j = 0; j < kWarpGroups; ++j) {
    const int first = (warp * kWarpGroups + j) * kGroup;  // in the tile
    const int64_t g = (base + first) / kGroup;
    if (g >= n_groups) break;  // the whole warp leaves together
    int count = 0;
#pragma unroll
    for (int i = 0; i < kGroup / 32; ++i) {
      const int q = first + 32 * i + lane;
      const int64_t p = base + q;
      bool keep = false;
      uint64_t h = 0;
      if (p < n) {
        bool ok;
        h = window_hash<32>(staged_window<32>(packed, bad, q, shape, &ok), shape, flags, seed);
        keep = survives(h, ok, p, length, shape.k, t_hi);
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
    __syncwarp();  // the slice is refilled by the next group
  }
}

// K10: the TPU kernel's own groups, one thread per group.  Block c of 16 384
// positions, staged with its halo, has 128 groups; group j holds positions
// 16384 c + 2048 s + j + 128 m (s < 8, m < 16), the lanes that the TPU
// kernel's halving folds (kmers_pallas.py:681-700) bring to column j, so
// neighbouring threads read neighbouring positions.  The thread keeps the 8
// smallest survivors by unsigned value in a sorted list in registers (every
// index is static: each step moves an entry down or takes the new value),
// duplicates kept, and writes rank i to slot 1024 c + 128 i + j; unused ranks
// keep the pad.  More than 8 survivors set *overflow.  Unlike K5's warp
// ballots and ranks, nothing is shared between threads but the staged codes,
// so the two kernels check each other.
__global__ void __launch_bounds__(kTopkWidth)
    kmer_topk_groups_kernel(const uint32_t* __restrict__ codes, int64_t n, int64_t length,
                            KmerShape shape, int flags, uint64_t seed, uint32_t t_hi,
                            uint32_t* __restrict__ clo, uint32_t* __restrict__ chi,
                            int32_t* __restrict__ overflow) {
  __shared__ uint32_t packed[staged_chunks(kBlock)];
  __shared__ uint32_t bad[staged_chunks(kBlock) / 2];
  const int64_t c = blockIdx.x;
  stage(CodeStream(codes, n, 0, flags), kBlock * c, staged_chunks(kBlock), packed, bad);
  __syncthreads();
  const int j = threadIdx.x;
  uint64_t best[kKeep];
#pragma unroll
  for (int i = 0; i < kKeep; ++i) best[i] = ~0ull;
  int count = 0;
  for (int s = 0; s < kGroups; ++s) {
    for (int m = 0; m < kRowBlock / kTopkWidth; ++m) {
      const int q = kRowBlock * s + j + kTopkWidth * m;
      bool ok;
      const uint64_t h = window_hash<32>(staged_window<32>(packed, bad, q, shape, &ok), shape,
                                         flags, seed);
      if (!survives(h, ok, kBlock * c + q, length, shape.k, t_hi)) continue;
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
__global__ void __launch_bounds__(kThreads)
    canonical_murmur_kernel(const uint64_t* __restrict__ F, const uint64_t* __restrict__ R,
                            int64_t n, KmerShape shape, int flags, uint64_t seed,
                            uint64_t* __restrict__ h1) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint64_t f = F[p];
  const uint64_t r = (flags & kFlagNoncanonical) ? f : R[p];
  h1[p] = canonical_hash(f, r, shape, flags, seed);
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
    kmer_hashes_kernel<16, ByteStream><<<blocks_for(n, kTile), kThreads, 0, s>>>(
        in, n, 0, KmerShape(k), flags, seed, out_lo, out_hi, out_valid);
  } else {
    kmer_hashes_kernel<32, ByteStream><<<blocks_for(n, kTile), kThreads, 0, s>>>(
        in, n, 0, KmerShape(k), flags, seed, out_lo, out_hi, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_kmer_hashes_masked(const void* seq, int64_t n, int64_t length, int32_t k,
                                         int32_t flags, uint64_t seed, uint32_t t_hi, void* lo,
                                         void* hi, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  kmer_masked_kernel<<<blocks_for(n, kTile), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, length, KmerShape(k), flags, seed, t_hi,
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_kmer_hashes_topk8(const void* seq, int64_t n, int64_t length, int32_t k,
                                        int32_t flags, uint64_t seed, uint32_t t_hi, void* clo,
                                        void* chi, void* overflow, void* stream) {
  const int64_t n_groups = (n + kGroup - 1) / kGroup;
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
  kmer_topk8_kernel<<<blocks_for(n, kTile), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, length, KmerShape(k), flags, seed, t_hi, n_groups,
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
      static_cast<const uint32_t*>(codes), n, length, KmerShape(k), flags, seed, t_hi,
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
    kmer_hashes_kernel<16, WrappedCodeStream><<<blocks_for(n, kTile), kThreads, 0, s>>>(
        in, n, np, KmerShape(k), flags, seed, out_lo, out_hi, out_valid);
  } else {
    kmer_hashes_kernel<32, WrappedCodeStream><<<blocks_for(n, kTile), kThreads, 0, s>>>(
        in, n, np, KmerShape(k), flags, seed, out_lo, out_hi, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fpmash_canonical_murmur(const void* F, const void* R, int64_t n, int32_t k,
                                       int32_t flags, uint64_t seed, void* h1, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  canonical_murmur_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(F), static_cast<const uint64_t*>(R), n, KmerShape(k), flags,
      seed, static_cast<uint64_t*>(h1));
  return static_cast<int>(cudaGetLastError());
}
