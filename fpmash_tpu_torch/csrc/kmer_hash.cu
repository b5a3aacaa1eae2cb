// Canonical k-mer MurmurHash3 kernels of the classic sketch: K7/K8, K6 and K5.
//
// Replace the Pallas kernels of fpmash_tpu/ops/kmers_pallas.py, which share
// one hash body (_canonical_murmur_body):
//   kmer_hashes_kernel<32>  _packed_slab_kernel (:510, K7; 16 < k <= 32)
//   kmer_hashes_kernel<16>  _slab_kernel (:411, K8; k <= 16)
//   kmer_masked_kernel      _packed_slab_masked_kernel (:544, K6)
//   kmer_topk8_kernel       _packed_slab_topk8r_kernel (:762, K5)
// Here too one __device__ function, window_hash, computes the hash of the
// window starting at position p of a flat byte stream, and the kernels are
// its three epilogues: unmasked planes and window validity; planes masked by
// validity, sequence length and a threshold on the high word; and the 8
// smallest survivors of every 128 positions.
//
// window_hash reads the window's k bytes straight from the stream: it folds
// a-z to upper case (unless preserve case), maps A C G T to 0-3 (any other
// byte, and any position past the stream's end, makes the window invalid and
// packs as code 0), builds the big-endian 2-bit window F and its packed
// reverse complement R (complement c ^ 3 at bit 2j) as u64, takes min(F, R)
// unless noncanonical, rebuilds its ASCII bytes as little-endian words and
// runs MurmurHash3_x64_128 over the k bytes, keeping h1.  The TPU kernels
// took pre-packed 16-code planes built by XLA ladders (and an XLA pass that
// turned bytes into codes); those passes are folded into this load.  Every
// shift is by less than the operand's width (F and R are built 2 bits at a
// time, bytes placed at 8 (j & 7) < 64), so k = 32 needs no guard.
//
// Planes: h1's low and high 32 bits as u32 (the TPU kernels' output layout);
// the wrappers keep them in int32 tensors.  A dropped lane holds 0xFFFFFFFF
// on both planes, and a survivor equal to that pair counts as a pad, as in the
// JAX package.
//
// What bounds it on the card: the arithmetic, about 300 integer operations per
// position at k = 21 (the packing loop, the byte rebuild and five 64-bit
// multiplies); the k byte loads per position overlap those of the neighbouring
// threads and come from L1.  One thread per position; keeping a block's span
// of the stream in shared memory and rolling F and R along it are left for
// later.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kGroup = 128;  // K5: positions per group
constexpr int kKeep = 8;     // K5: survivors kept per group
constexpr int kFlagNoncanonical = 1;
constexpr int kFlagPreserveCase = 2;

__device__ __forceinline__ uint32_t base_code(uint8_t b, bool preserve_case) {
  if (!preserve_case && b >= 'a' && b <= 'z') b -= 32;
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 4;
  }
}

// h1 of the canonical k-mer at position p (k <= MaxK <= 32); *valid is true
// iff its k bytes lie in the stream and are all A, C, G or T.
template <int MaxK>
__device__ __forceinline__ uint64_t window_hash(const uint8_t* __restrict__ seq, int64_t n,
                                                int64_t p, int k, int flags, uint64_t seed,
                                                bool* valid) {
  const bool preserve_case = flags & kFlagPreserveCase;
  uint64_t F = 0, R = 0;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < MaxK; ++j) {
    if (j < k) {
      const int64_t q = p + j;
      const uint32_t code = q < n ? base_code(seq[q], preserve_case) : 4u;
      ok &= code < 4;
      const uint64_t c = code & 3u;
      F = (F << 2) | c;
      R |= (c ^ 3u) << (2 * j);
    }
  }
  *valid = ok;
  const uint64_t P = ((flags & kFlagNoncanonical) || F <= R) ? F : R;

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

// K7/K8: unmasked planes and window validity.
template <int MaxK>
__global__ void kmer_hashes_kernel(const uint8_t* __restrict__ seq, int64_t n, int k, int flags,
                                   uint64_t seed, uint32_t* __restrict__ lo,
                                   uint32_t* __restrict__ hi, uint8_t* __restrict__ valid) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  bool ok;
  const uint64_t h = window_hash<MaxK>(seq, n, p, k, flags, seed, &ok);
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
  bool ok;
  const uint64_t h = window_hash<32>(seq, n, p, k, flags, seed, &ok);
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
// over.
__global__ void kmer_topk8_kernel(const uint8_t* __restrict__ seq, int64_t n, int64_t length,
                                  int k, int flags, uint64_t seed, uint32_t t_hi,
                                  int64_t n_groups, uint32_t* __restrict__ clo,
                                  uint32_t* __restrict__ chi, int32_t* __restrict__ overflow) {
  __shared__ uint64_t survivors[kThreads / 32][kGroup];
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
      h = window_hash<32>(seq, n, p, k, flags, seed, &ok);
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
    kmer_hashes_kernel<16><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, k, flags, seed, out_lo, out_hi, out_valid);
  } else {
    kmer_hashes_kernel<32><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        in, n, k, flags, seed, out_lo, out_hi, out_valid);
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
