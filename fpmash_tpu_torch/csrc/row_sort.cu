// Bitonic row sort of (key, payload) u32 planes: K15.
//
// Replaces the Pallas kernel fpmash_tpu/ops/sort_pallas.py:28 _psort_kernel
// (reached through row_sort_planes_pallas; unrouted in the JAX package, whose
// bottom-k stays on lax.sort).  Each row of 4 096 pairs is sorted ascending
// by key as unsigned, the payload moving with its key.
//
// It runs the TPU kernel's network exactly: stages s = 2, 4, ..., 4096 and
// distances d = s/2, ..., 1; element i meets i ^ d; the pair is ascending iff
// (i & s) == 0; and it swaps only on a strict inequality, so equal keys never
// move past each other.  Hence the payload order among equal keys, and not
// only the keys, equals the TPU kernel's (lax.sort orders ties otherwise, and
// so would any radix or merge sort).  Only where the pairs sit changes.
//
// What bounds it on the card: the network's operations, 78 steps of 2 048
// compare-exchanges a row, about 5 32-bit operations each: 0.1956 ms at
// [4096, 4096]; the 128 MiB read and 128 MiB written take 0.080 ms.  The
// first design (one block of 1 024 threads a row, every step a round trip
// through 32 KB of shared memory and a __syncthreads(), two blocks an SM)
// took 0.80 ms there, slower than torch.sort + gather (0.71 ms).
//
// Design: 256 threads a row, each holding a run of kPer = 16 consecutive
// pairs in registers, loaded and stored as 16-byte vectors.
//   d < 16 (42 of the 78 steps): both elements in one thread's registers, no
//     barrier and no exchange;
//   16 <= d < 512 (30 steps): the partner is lane ^ (d / 16) of the same warp,
//     two __shfl_xor_sync an element (key and payload);
//   d >= 512 (6 steps, stages 1024-4096): the partner is in another warp; the
//     pairs go through 32 KB of shared memory, laid out so that neighbouring
//     threads touch neighbouring 16-byte words, between two __syncthreads().
// From stage 16 on, every pair a thread touches in a stage has the same
// direction, so a thread keeps its keys complemented in the stages where it
// sorts descending: every comparator is then ascending, one unsigned compare
// (a < b on the complements is b < a on the keys, ties still never swap).
// Stage 4096 is ascending everywhere, so the keys leave uncomplemented.
// Blocks of 256 threads with 32 KB of shared memory and at most 64 registers
// a thread (__launch_bounds__; 62 used, no spills) leave room for four blocks
// on an SM.  On an H100 (700 W) it takes 0.47-0.48 ms at [4096, 4096], below
// torch.sort + gather (0.71 ms): 41 % of its bound.  Most of that is the 30
// shuffle steps; runs of 8 were slower, runs of 32 need 128 registers and
// spill.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4096;
constexpr int kPer = 16;                // consecutive pairs a thread holds
constexpr int kThreads = kCols / kPer;  // 256 threads a row
constexpr int kWarpSpan = 32 * kPer;    // pairs a warp holds: 512
constexpr int kVec = kPer / 4;          // 16-byte vectors a thread's run fills
constexpr unsigned kAll = 0xffffffffu;

// Compare-exchange of registers r and r + D of every thread at stage S: the
// direction by (i & S) for the first stages (S < kPer, where it varies with
// r), ascending from stage kPer on (descending runs hold complemented keys).
template <int S, int D>
__device__ __forceinline__ void register_step(uint32_t (&k)[kPer], uint32_t (&v)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if ((r & D) == 0) {
      constexpr bool kAnyOrder = S >= kPer;
      const int j = r | D;
      const bool ascending = kAnyOrder || (r & S) == 0;
      const uint32_t a = k[r], b = k[j];
      const bool swap = ascending ? b < a : a < b;
      const uint32_t va = v[r], vb = v[j];
      k[r] = swap ? b : a;
      k[j] = swap ? a : b;
      v[r] = swap ? vb : va;
      v[j] = swap ? va : vb;
    }
  }
}

// Every step of stage S from distance D down to 1, all in registers.
template <int S, int D>
__device__ __forceinline__ void register_steps(uint32_t (&k)[kPer], uint32_t (&v)[kPer]) {
  register_step<S, D>(k, v);
  if constexpr (D > 1) register_steps<S, D / 2>(k, v);
}

// Stages S, 2S, ... below kPer: inside each thread's run.
template <int S>
__device__ __forceinline__ void register_stages(uint32_t (&k)[kPer], uint32_t (&v)[kPer]) {
  register_steps<S, S / 2>(k, v);
  if constexpr (2 * S < kPer) register_stages<2 * S>(k, v);
}

// The partner's pair (pk, pv) has been fetched: the lower element of an
// ascending pair takes it where it is strictly smaller, the upper one where
// it is strictly larger.
__device__ __forceinline__ void take_partner(uint32_t& k, uint32_t& v, uint32_t pk, uint32_t pv,
                                             bool lower) {
  const bool take = lower ? pk < k : k < pk;
  k = take ? pk : k;
  v = take ? pv : v;
}

// A step of distance kPer <= d < kWarpSpan: the partner is lane ^ (d / kPer).
__device__ __forceinline__ void warp_step(uint32_t (&k)[kPer], uint32_t (&v)[kPer], int d) {
  const int mask = d / kPer;
  const bool lower = (threadIdx.x & mask) == 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const uint32_t pk = __shfl_xor_sync(kAll, k[r], mask);
    const uint32_t pv = __shfl_xor_sync(kAll, v[r], mask);
    take_partner(k[r], v[r], pk, pv, lower);
  }
}

// A step of distance d >= kWarpSpan, through shared memory: vector m of
// thread t sits at m * kThreads + t.
__device__ __forceinline__ void block_step(uint32_t (&k)[kPer], uint32_t (&v)[kPer], uint4* sk,
                                           uint4* sv, int d) {
  const int t = threadIdx.x;
  __syncthreads();  // every thread has read the last exchange
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    sk[m * kThreads + t] = make_uint4(k[4 * m], k[4 * m + 1], k[4 * m + 2], k[4 * m + 3]);
    sv[m * kThreads + t] = make_uint4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
  __syncthreads();
  const int p = t ^ (d / kPer);
  const bool lower = (t & (d / kPer)) == 0;
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const uint4 qk = sk[m * kThreads + p];
    const uint4 qv = sv[m * kThreads + p];
    take_partner(k[4 * m], v[4 * m], qk.x, qv.x, lower);
    take_partner(k[4 * m + 1], v[4 * m + 1], qk.y, qv.y, lower);
    take_partner(k[4 * m + 2], v[4 * m + 2], qk.z, qv.z, lower);
    take_partner(k[4 * m + 3], v[4 * m + 3], qk.w, qv.w, lower);
  }
}

// Complement of the keys a thread holds in stage s (>= kPer): all ones where
// its run sorts descending.
__device__ __forceinline__ uint32_t descending_mask(int s) {
  return (threadIdx.x * kPer) & s ? kAll : 0u;
}

__global__ void __launch_bounds__(kThreads, 4)
row_sort_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ payload,
                uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_payload) {
  __shared__ uint4 sk[kCols / 4];
  __shared__ uint4 sv[kCols / 4];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x * kPer;
  const uint4* gk = reinterpret_cast<const uint4*>(keys + base);
  const uint4* gv = reinterpret_cast<const uint4*>(payload + base);
  uint32_t k[kPer], v[kPer];
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const uint4 a = gk[m], b = gv[m];
    k[4 * m] = a.x, k[4 * m + 1] = a.y, k[4 * m + 2] = a.z, k[4 * m + 3] = a.w;
    v[4 * m] = b.x, v[4 * m + 1] = b.y, v[4 * m + 2] = b.z, v[4 * m + 3] = b.w;
  }

  register_stages<2>(k, v);

  uint32_t flip = 0;  // the complement the keys carry
#pragma unroll 1
  for (int s = kPer; s <= kCols; s <<= 1) {
    const uint32_t now = descending_mask(s);
#pragma unroll
    for (int r = 0; r < kPer; ++r) k[r] ^= flip ^ now;
    flip = now;
#pragma unroll 1
    for (int d = s >> 1; d >= kWarpSpan; d >>= 1) block_step(k, v, sk, sv, d);
#pragma unroll 1
    for (int d = min(s >> 1, kWarpSpan >> 1); d >= kPer; d >>= 1) warp_step(k, v, d);
    register_steps<kPer, kPer / 2>(k, v);
  }

  uint4* ok = reinterpret_cast<uint4*>(out_keys + base);
  uint4* ov = reinterpret_cast<uint4*>(out_payload + base);
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    ok[m] = make_uint4(k[4 * m], k[4 * m + 1], k[4 * m + 2], k[4 * m + 3]);
    ov[m] = make_uint4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
}

}  // namespace

// K15 over n_rows rows of 4 096 pairs; every pointer 16-byte aligned.
extern "C" int fpmash_row_sort(const void* keys, const void* payload, int64_t n_rows,
                               void* out_keys, void* out_payload, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const uintptr_t any = reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(payload) |
                        reinterpret_cast<uintptr_t>(out_keys) |
                        reinterpret_cast<uintptr_t>(out_payload);
  if (any % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  row_sort_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(payload),
      static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_payload));
  return static_cast<int>(cudaGetLastError());
}
