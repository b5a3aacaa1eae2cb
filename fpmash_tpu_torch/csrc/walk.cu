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
// Hashes compare as unsigned 64-bit values; lengths are clamped to [0, S].
//
// Design: a block takes one reference row and up to kThreads queries, one
// lane a pair, and stages the reference row's la hashes in shared memory
// once with 16-byte loads (8-byte ones at its ends); a row wider than
// kStageWidth hashes is read from device memory instead, by the same code.
// Each lane's query row streams through a ring of kRing hashes of its own in
// shared memory, filled kHalf hashes at a time by asynchronous 16-byte
// copies (cp.async), so a step reads both of its hashes from shared memory
// and no load from device memory is waited for in the step that uses it.
// Lanes walk in rounds of kHalf steps: at the end of a round a lane whose
// ring holds fewer than (kDepth + 1) kHalf hashes ahead of it copies the
// next kHalf, and a round waits only for the copies issued kDepth rounds
// back.  The step has no branch: advance i on a <= b and j on b <= a, count
// common where both advance, all predicated on `live`.  Nothing is read
// outside a list's first la (lb) elements.  The TPU kernel's shift-register
// lane rolls, pair packing and multiple-of-8 row tiles avoided gathers on
// the TPU and are not carried over.
//
// What bounds it on the card: each pair's walk is serial, up to min(s, la +
// lb) steps of two dependent shared-memory loads, two 64-bit compares and
// predicated counts, and the ring's copies are one 16-byte request a lane
// at scattered addresses; both are far from the bytes' bound (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Reference rows up to this many hashes are staged (48 KB of shared memory).
constexpr int64_t kStageWidth = 6144;
// A lane's ring: kRing query hashes, refilled kHalf at a time, kDepth rounds
// ahead of their reads, padded by one 16-byte chunk so that the rings of
// neighbouring lanes start in other banks.
constexpr int kHalf = 4;
constexpr int kDepth = 1;
constexpr int kRing = 16;
constexpr int kRingStride = kRing + 2;
static_assert(kRing >= (kDepth + 2) * kHalf, "a fill would overwrite hashes not yet read");
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Elements c and c + 1 of list[0, len) (0 outside it): one 16-byte load when
// both lie inside, else 8-byte loads of those that do.  list + c must be
// 16-byte aligned.
__device__ __forceinline__ void load_chunk(const uint64_t* __restrict__ list, int32_t len,
                                           int32_t c, uint64_t& v0, uint64_t& v1) {
  if (c >= 0 && c + 1 < len) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(list + c);
    v0 = v.x;
    v1 = v.y;
  } else {
    v0 = (c >= 0 && c < len) ? list[c] : 0;
    v1 = (c + 1 >= 0 && c + 1 < len) ? list[c + 1] : 0;
  }
}

// 1 when list[0] is the second hash of its aligned 16-byte chunk, else 0.
__device__ __forceinline__ int32_t chunk_phase(const uint64_t* list) {
  return static_cast<int32_t>((reinterpret_cast<uintptr_t>(list) >> 3) & 1);
}

// src[0, n) into dst[0, n) by the block's threads, a chunk a thread.
__device__ __forceinline__ void stage(const uint64_t* __restrict__ src, int32_t n,
                                      uint64_t* __restrict__ dst) {
  for (int32_t c = 2 * static_cast<int32_t>(threadIdx.x) - chunk_phase(src); c < n;
       c += 2 * static_cast<int32_t>(blockDim.x)) {
    uint64_t v0, v1;
    load_chunk(src, n, c, v0, v1);
    if (c >= 0) dst[c] = v0;
    if (c + 1 < n) dst[c + 1] = v1;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory load at a 32-bit shared address; volatile, so that it
// stays after the wait for the copies that wrote it.
__device__ __forceinline__ uint64_t lds64(uint32_t addr) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}

// list[e, e + 2) into the 16-byte aligned shared address `dst`: the bytes
// of its elements below len (the rest zero), nothing read at or past len.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const uint64_t* __restrict__ list,
                                           int32_t len, int32_t e) {
  const int32_t bytes = e + 1 < len ? 16 : e < len ? 8 : 0;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p cp.async.cg.shared.global [%0], [%1], 16, %2;\n\t}" ::"r"(dst),
      "l"(list + e), "r"(bytes));
}

// The hashes of list[0, len) in [c, c + kHalf), c >= 0 at a chunk boundary,
// into the ring slots of their elements (element e in slot (e + phase) %
// kRing, so that a chunk's slots are 16-byte aligned and never wrap; `ring`
// is the ring's shared address).
__device__ __forceinline__ void fill(uint32_t ring, const uint64_t* __restrict__ list,
                                     int32_t len, int32_t phase, int32_t c) {
#pragma unroll
  for (int32_t k = 0; k < kHalf; k += 2) {
    copy_chunk(ring + (((c + k + phase) & (kRing - 1)) << 3), list, len, c + k);
  }
}

__device__ __forceinline__ int32_t clamp_len(int32_t len, int64_t stride) {
  return len < 0 ? 0 : len > stride ? static_cast<int32_t>(stride) : len;
}

// Block b takes reference row b / q_tiles and queries (b % q_tiles) *
// blockDim.x + threadIdx.x; kStaged reads the reference row from shared
// memory.  Shared memory: the staged row (ref_stride hashes, rounded up to
// a chunk) when kStaged, then one ring a thread.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint64_t* __restrict__ ref, const int32_t* __restrict__ ref_len,
            int64_t ref_stride, const uint64_t* __restrict__ qry,
            const int32_t* __restrict__ qry_len, int64_t n_qry, int64_t qry_stride,
            int32_t sketch_size, int64_t q_tiles, int32_t* __restrict__ common_out,
            int32_t* __restrict__ denom_out) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int64_t r = blockIdx.x / q_tiles;
  const int64_t q = (blockIdx.x - r * q_tiles) * blockDim.x + threadIdx.x;
  const int32_t la = clamp_len(ref_len[r], ref_stride);
  const uint64_t* __restrict__ A = ref + r * ref_stride;
  uint64_t* ring = smem + (kStaged ? (ref_stride + 1) / 2 * 2 : 0) + threadIdx.x * kRingStride;
  if constexpr (kStaged) {
    stage(A, la, smem);
    A = smem;
  }
  // lanes past the last query take no step but share their warp's rounds
  const int32_t lb = q < n_qry ? clamp_len(qry_len[q], qry_stride) : 0;
  const uint64_t* __restrict__ B = qry + (q < n_qry ? q : 0) * qry_stride;
  const int32_t phase = chunk_phase(B);
  const uint32_t ring_s = smem_addr(ring), row_s = smem_addr(smem);
  // the ring holds, or is copying, B[filled - kRing, filled); the first
  // chunk of a list that starts at its second half is copied 8 bytes alone
  if (phase && lb > 0) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(ring_s + 8), "l"(B));
  }
  int32_t filled = phase;
  for (int32_t h = 0; h <= kDepth; ++h, filled += kHalf) fill(ring_s, B, lb, phase, filled);
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  int32_t i = 0, j = 0, common = 0, denom = 0;
  bool live = sketch_size > 0 && la > 0 && lb > 0;
  while (__any_sync(kFullMask, live)) {
#pragma unroll
    for (int32_t t = 0; t < kHalf; ++t) {
      // a staged row is read past la only into the rings, which follow it
      const uint64_t a = kStaged ? lds64(row_s + (i << 3)) : live ? A[i] : 0;
      const uint64_t b = lds64(ring_s + (((j + phase) & (kRing - 1)) << 3));
      const bool adv_i = live && a <= b, adv_j = live && b <= a;
      i += adv_i;
      j += adv_j;
      common += adv_i && adv_j;
      denom += live;
      live = denom < sketch_size && i < la && j < lb;
    }
    // the ring keeps (kDepth + 1) kHalf hashes ahead of j: copy the next
    // kHalf, and wait for the copies of kDepth rounds back, which the next
    // round may read
    if (live && filled - j < (kDepth + 1) * kHalf) {
      fill(ring_s, B, lb, phase, filled);
      filled += kHalf;
    }
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group %0;" ::"n"(kDepth) : "memory");
  }
  if (denom < sketch_size) {
    const int64_t rest = static_cast<int64_t>(denom) + (la - i) + (lb - j);
    denom = rest < sketch_size ? static_cast<int32_t>(rest) : sketch_size;
  }
  if (q < n_qry) {
    const int64_t pair = r * n_qry + q;
    common_out[pair] = common;
    denom_out[pair] = denom;
  }
}

template <bool kStaged>
cudaError_t launch(unsigned int blocks, unsigned int threads, size_t smem, cudaStream_t stream,
                   const uint64_t* ref, const int32_t* ref_len, int64_t ref_stride,
                   const uint64_t* qry, const int32_t* qry_len, int64_t n_qry, int64_t qry_stride,
                   int32_t sketch_size, int64_t q_tiles, int32_t* common, int32_t* denom) {
  const cudaError_t opt_in = cudaFuncSetAttribute(
      walk_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return opt_in;
  walk_kernel<kStaged><<<blocks, threads, smem, stream>>>(ref, ref_len, ref_stride, qry, qry_len,
                                                          n_qry, qry_stride, sketch_size, q_tiles,
                                                          common, denom);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fpmash_walk(const void* ref, const void* ref_len, int64_t n_ref, int64_t ref_stride,
                           const void* qry, const void* qry_len, int64_t n_qry, int64_t qry_stride,
                           int32_t sketch_size, void* common, void* denom, void* stream) {
  if (n_ref <= 0 || n_qry <= 0) return static_cast<int>(cudaSuccess);
  // a block of whole warps, no wider than the queries need
  const int64_t threads = n_qry >= kThreads ? kThreads : (n_qry + 31) / 32 * 32;
  const int64_t q_tiles = (n_qry + threads - 1) / threads;
  const int64_t blocks = n_ref * q_tiles;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool staged = ref_stride <= kStageWidth;
  const size_t smem =
      ((staged ? (ref_stride + 1) / 2 * 2 : 0) + threads * kRingStride) * sizeof(uint64_t);
  auto run = staged ? launch<true> : launch<false>;
  return static_cast<int>(run(
      static_cast<unsigned int>(blocks), static_cast<unsigned int>(threads), smem,
      static_cast<cudaStream_t>(stream), static_cast<const uint64_t*>(ref),
      static_cast<const int32_t*>(ref_len), ref_stride, static_cast<const uint64_t*>(qry),
      static_cast<const int32_t*>(qry_len), n_qry, qry_stride, sketch_size, q_tiles,
      static_cast<int32_t*>(common), static_cast<int32_t*>(denom)));
}
