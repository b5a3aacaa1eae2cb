// Fingerprint kernels: Duval (CFL) factorization + MurmurHash3_x64_128 per window (K1, K13).
//
// Replace the Pallas kernels of fpmash_tpu/ops/fused_pallas.py reached through
// fingerprint_hashes_fused and fingerprint_hashes_fused_words:
//   fingerprint_kernel<StreamStarts>  _split_kernel (:339, K1; variant "split", routed)
//   fingerprint_kernel<RowStarts>     _fused_kernel (:189, K13; variant "inline")
// For each window they compute MurmurHash3_x64_128 (seed `seed`) of the u64
// vector of the window's CFL factor lengths, and the factor count: the odd
// last length is mixed into h1 only and the byte length is 8 * count, as
// murmur3_u64_batch does.  A window that does not lie inside its byte array
// gets count -1 and zero hashes and is never read.
//
//   K1 reads one flat byte stream: the host ships each read once (upper case,
//   followed by its first 99 bytes for the cyclic shift windows) and names
//   each window by its start offset and length.  Bytes compare as unsigned,
//   which keeps A<C<G<T and orders any other byte exactly as the TPU kernel's
//   byte4 packing did.
//
//   K13 reads u8 rows [B, L] (window b starts at b * L, lengths in [0, L],
//   which the wrapper checks) under the JAX function's two packings: byte4
//   compares raw bytes; dna16 compares the codes C -> 1, G -> 2, T -> 3 and
//   any other byte -> 0, so an N compares like an A (fused_pallas.py:583-589).
//
// One __global__ body serves both; they differ only in where a window starts
// and how a staged byte is mapped.  The TPU kernels' layouts (sublane groups,
// the boundary bitmask phase, the binary select tree over packed words, the
// [L, R] transpose of the inline kernel) existed to keep 8x128 vector lanes
// busy and are not carried over.
//
// What bounds it on the card: not memory (a window's 100 bytes are read once
// into shared memory, 20 bytes go out) but the serial Duval automaton, about
// 1.05 steps a character, each one or two dependent loads, and the lanes of a
// warp that are in different phases of their windows (with every window the
// same, K1 runs 1.8x faster on an NVIDIA H100 80GB HBM3 at 700 W).  The
// design:
//
//   Input staged once.  A block takes consecutive windows; where their span
//   fits the launch's cap it is staged into shared memory with 16-byte loads
//   at 16-byte aligned addresses (the head and tail chunks byte by byte, so
//   nothing outside the array is read), each 4-byte word mapped once by the
//   pack (dna16: the code from bits 1-2, checked against its letter by a
//   byte permute).  K1's shift windows always fit (256 windows of 100 span at
//   most 256 + 2 * 99 bytes; the cap takes spans up to 2 T + 2 048); a block
//   of K13 rows is T * L contiguous bytes, staged for L <= 128, so the row
//   loads coalesce.  Other blocks (arbitrary starts, whole reads, the split
//   variant's rows, rows over 128) read device memory through the same
//   automaton code over a second text type, dna16 mapped at the read.
//   One flat Duval loop: a step either extends the scan of the longest
//   prefix of w[i:] that is a power of a Lyndon word or emits one of its
//   factors, so a warp waits for its slowest lane once a step, not at every
//   inner loop's exit.  Windows of up to 128 characters set their factor
//   starts in four registers (selects on p >> 5) and are hashed after the
//   loop, two factors a block update; longer windows feed each factor
//   length to the hash as it is emitted (for all windows that is 16 %
//   slower at 512 000 windows of 100, the same card).
// The block size is the one of 256, 128, 64 or 32 threads that keeps the most
// threads on an SM with the launch's shared memory, so every block is whole
// warps; each instance keeps the shape of its last call, so repeated calls
// make no host queries.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRegWidth = 128;      // windows up to this keep their factor starts in registers
constexpr int kStreamSlack = 2048;  // K1's staged span: 2 bytes a window and this many more
constexpr int kRowStageWidth = 128; // K13 rows up to this wide are staged

extern __shared__ __align__(16) uint8_t smem[];

__host__ __device__ constexpr int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

// The packs, on the four bytes of a word at once.  Identity (K1, and K13
// under byte4).
struct RawBytes {
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const { return x; }
};

// K13 under dna16: C G T -> 1 2 3, any other byte -> 0.  Bits 1-2 of a byte,
// xor its bit 2, give A C G T the codes 0 1 2 3; a byte keeps its code only
// if it is that code's letter (byte permute of "ACGT", compared per byte).
struct Dna16Codes {
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    const uint32_t c = ((x >> 1) & 0x03030303u) ^ ((x >> 2) & 0x01010101u);
    const uint32_t sel = (c & 0x3u) | ((c >> 4) & 0x30u) | ((c >> 8) & 0x300u) |
                         ((c >> 12) & 0x3000u);
    return c & __vcmpeq4(x, __byte_perm(0x54474341u, 0, sel));
  }
};

// Where window b starts: K1's starts array, or K13's rows of `width`.
struct StreamStarts {
  const int64_t* __restrict__ starts;
  __device__ __forceinline__ int64_t operator()(int64_t b) const { return starts[b]; }
};

struct RowStarts {
  int64_t width;
  __device__ __forceinline__ int64_t operator()(int64_t b) const { return b * width; }
};

// The texts the automaton reads: a window staged in shared memory (already
// mapped), or in device memory, mapped at the read.
struct StagedText {
  int32_t off;
  __device__ __forceinline__ uint32_t operator[](int32_t x) const { return smem[off + x]; }
};

template <class Code>
struct DeviceText {
  const uint8_t* __restrict__ s;
  __device__ __forceinline__ uint32_t operator[](int32_t x) const { return Code{}(s[x]); }
};

// Bits of a window of up to 128 positions in four registers; a run-time index
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
  // The lowest set bit, cleared; `none` when no bit is set.
  __device__ __forceinline__ int32_t pop_lowest(int32_t none) {
    const int32_t q = w0 ? 0 : w1 ? 1 : w2 ? 2 : w3 ? 3 : 4;
    const uint32_t w = q == 0 ? w0 : q == 1 ? w1 : q == 2 ? w2 : w3;
    w0 &= q == 0 ? w0 - 1 : ~0u;
    w1 &= q == 1 ? w1 - 1 : ~0u;
    w2 &= q == 2 ? w2 - 1 : ~0u;
    w3 &= q == 3 ? w3 - 1 : ~0u;
    return q == 4 ? none : 32 * q + __ffs(static_cast<int>(w)) - 1;
  }
};

// One flat Duval loop over w[0, n): an iteration is one scan step, or the
// emission of one factor of length p = j - k starting at i (an emitting step
// leaves j and k as they were, so the next step reads the same pair and
// emits again until i passes k).
template <class Text, class Emit>
__device__ __forceinline__ void duval(const Text& w, int32_t n, Emit emit) {
  int32_t i = 0, j = 1, k = 0;
  while (i < n) {
    const bool inside = j < n;
    const uint32_t a = inside ? w[k] : 0u, c = inside ? w[j] : 0u;
    if (inside && a <= c) {
      k = (a < c) ? i : k + 1;
      ++j;
    } else {
      emit(i, j - k);
      i += j - k;
      if (i > k) {
        j = i + 1;
        k = i;
      }
    }
  }
}

// MurmurHash3 of the factor lengths of w[0, n).  Up to 128 characters the
// loop only marks factor starts and the hash reads them afterwards, two
// lengths a block update; above, each length is hashed as it is emitted.
template <class Text>
__device__ __forceinline__ void fingerprint_window(const Text& w, int32_t n,
                                                   fpmash::Murmur64& hash) {
  if (n <= kRegWidth) {
    RegBits starts;
    duval(w, n, [&](int32_t i, int32_t) { starts.set(i); });
    starts.pop_lowest(n);  // start 0
    for (int32_t pos = 0; pos < n;) {
      const int32_t a = starts.pop_lowest(n);
      if (a >= n) {
        hash.add(static_cast<uint64_t>(a - pos));
        break;
      }
      const int32_t b = starts.pop_lowest(n);
      hash.add_pair(static_cast<uint64_t>(a - pos), static_cast<uint64_t>(b - a));
      pos = b;
    }
  } else {
    duval(w, n, [&](int32_t, int32_t p) { hash.add(static_cast<uint64_t>(p)); });
  }
  hash.finish();
}

// Windows b of [0, n_windows), window b = src[at(b), at(b) + lengths[b]) of
// the n_src bytes at src; a block's span is staged when it fits `cap` bytes.
template <class Starts, class Code>
__global__ void __launch_bounds__(kMaxThreads)
fingerprint_kernel(const uint8_t* __restrict__ src, int64_t n_src, Starts at,
                   const int32_t* __restrict__ lengths, int64_t n_windows, uint64_t seed,
                   int32_t cap, uint64_t* __restrict__ h1_out, uint64_t* __restrict__ h2_out,
                   int32_t* __restrict__ count_out) {
  __shared__ int64_t span_lo[kMaxThreads / 32], span_hi[kMaxThreads / 32];
  const int threads = blockDim.x, t = threadIdx.x;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * threads + t;

  int64_t start = 0;
  int32_t n = 0;
  bool valid = false;
  if (b < n_windows) {
    start = at(b);
    n = lengths[b];
    valid = start >= 0 && n >= 0 && start <= n_src - n;
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
  for (int v = 0; v < threads >> 5; ++v) {
    lo = span_lo[v] < lo ? span_lo[v] : lo;
    hi = span_hi[v] > hi ? span_hi[v] : hi;
  }
  // staged bytes smem[x] = code(src[g0 + x]), g0 the 16-byte aligned address at or below lo
  const int64_t g0 =
      hi >= 0 ? lo - static_cast<int64_t>((reinterpret_cast<uintptr_t>(src) + lo) & 15) : 0;
  const int64_t staged_len = align16(hi - g0);
  const bool staged = hi >= 0 && staged_len <= cap;  // uniform over the block
  if (staged) {
    const Code code{};
    for (int ch = t; ch < static_cast<int>(staged_len >> 4); ch += threads) {
      const int64_t q = g0 + 16 * ch;
      uint4 v;
      if (q >= 0 && q + 16 <= n_src) {
        v = *reinterpret_cast<const uint4*>(src + q);
      } else {
        uint32_t x[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16; ++i)
          if (q + i >= 0 && q + i < n_src)
            x[i >> 2] |= static_cast<uint32_t>(src[q + i]) << (8 * (i & 3));
        v = make_uint4(x[0], x[1], x[2], x[3]);
      }
      *reinterpret_cast<uint4*>(smem + 16 * ch) = make_uint4(code(v.x), code(v.y), code(v.z),
                                                             code(v.w));
    }
    __syncthreads();
  }

  if (b >= n_windows) return;
  if (!valid) {
    h1_out[b] = 0;
    h2_out[b] = 0;
    count_out[b] = -1;
    return;
  }
  fpmash::Murmur64 hash(seed);
  if (staged) {
    fingerprint_window(StagedText{static_cast<int32_t>(start - g0)}, n, hash);
  } else {
    fingerprint_window(DeviceText<Code>{src + start}, n, hash);
  }
  h1_out[b] = hash.h1;
  h2_out[b] = hash.h2;
  count_out[b] = hash.count;
}

// The staged span's bytes for a block of `threads`: K1 (width < 0) takes
// spans of 2 bytes a window and kStreamSlack more (shift windows up to 1 024
// characters); K13 a block's rows of up to kRowStageWidth, else nothing.
__host__ __device__ constexpr int32_t span_cap(int threads, int64_t width) {
  return width < 0 ? static_cast<int32_t>(align16(2 * threads + kStreamSlack) + 16)
         : width <= kRowStageWidth ? static_cast<int32_t>(align16(threads * width) + 16)
                                   : 0;
}

// A launch shape: the block size and its staged span's bytes.
struct Shape {
  int device = -1;
  int64_t width = -2;
  int threads = 0;
  int32_t cap = 0;
};

// The block size with the most threads resident an SM for rows of `width`
// (K1: -1) on `device`; also raises the instance's dynamic shared-memory
// limit to the card's opt-in limit less its static shared memory.
template <class Starts, class Code>
cudaError_t find_shape(int device, int64_t width, Shape* out) {
  auto kernel = fingerprint_kernel<Starts, Code>;
  int optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  optin -= static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;

  int best_active = 0;
  Shape best{device, width};
  for (int threads = kMaxThreads; threads >= 32; threads >>= 1) {
    const int32_t cap = span_cap(threads, width);
    if (cap > optin) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        static_cast<size_t>(cap));
    if (err != cudaSuccess) return err;
    if (blocks * threads > best_active) {
      best_active = blocks * threads;
      best.threads = threads;
      best.cap = cap;
    }
  }
  if (best.threads == 0) return cudaErrorInvalidValue;
  *out = best;
  return cudaSuccess;
}

template <class Starts, class Code>
int launch(const uint8_t* src, int64_t n_src, Starts at, int64_t width, const void* lengths,
           int64_t n_windows, uint64_t seed, void* h1, void* h2, void* count,
           cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the shape depends only on the card and the row width: each instance
  // keeps its last one, so repeated calls make no host queries
  static std::mutex mu;
  static Shape kept;
  Shape shape;
  {
    const std::lock_guard<std::mutex> lock(mu);
    shape = kept;
  }
  if (shape.device != device || shape.width != width) {
    err = find_shape<Starts, Code>(device, width, &shape);
    if (err != cudaSuccess) return static_cast<int>(err);
    const std::lock_guard<std::mutex> lock(mu);
    kept = shape;
  }
  const int64_t blocks = (n_windows + shape.threads - 1) / shape.threads;
  fingerprint_kernel<Starts, Code>
      <<<static_cast<unsigned int>(blocks), shape.threads, static_cast<size_t>(shape.cap),
         stream>>>(src, n_src, at, static_cast<const int32_t*>(lengths), n_windows, seed,
                   shape.cap, static_cast<uint64_t*>(h1), static_cast<uint64_t*>(h2),
                   static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fpmash_fingerprint(const void* flat, int64_t n_flat, const void* starts,
                                  const void* lengths, int64_t n_windows, uint64_t seed,
                                  void* h1, void* h2, void* count, void* stream) {
  if (n_windows <= 0) return static_cast<int>(cudaSuccess);
  return launch<StreamStarts, RawBytes>(
      static_cast<const uint8_t*>(flat), n_flat, StreamStarts{static_cast<const int64_t*>(starts)},
      -1, lengths, n_windows, seed, h1, h2, count, static_cast<cudaStream_t>(stream));
}

// K13 over rows [n_rows, width]; pack 0 is byte4, 1 is dna16.
extern "C" int fpmash_fingerprint_rows(const void* rows, int64_t n_rows, int32_t width,
                                       const void* lengths, int32_t pack, uint64_t seed,
                                       void* h1, void* h2, void* count, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint8_t*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  const RowStarts at{width};
  if (pack == 1)
    return launch<RowStarts, Dna16Codes>(src, n_rows * width, at, width, lengths, n_rows, seed,
                                         h1, h2, count, s);
  return launch<RowStarts, RawBytes>(src, n_rows * width, at, width, lengths, n_rows, seed, h1,
                                     h2, count, s);
}

extern "C" const char* fpmash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
