// MurmurHash3_x64_128 of each row's factor-length vector, straight from its
// factor-start words.
//
// Replaces the Pallas kernel fpmash_tpu/ops/icfl_pallas.py:291
// _hash_words_kernel (reached through hash_from_words_fused).  Row b has length
// n = lengths[b] and factor-start bits in words[b, :] (bit p&31 of word p>>5 is
// position p).  The factorization starts at 0 whatever bit 0 says, and bits at
// positions >= n are ignored; the factor lengths are the gaps between
// consecutive starts, the last one up to n.  It returns MurmurHash3_x64_128 of
// that u64 vector (as murmur3_u64_batch) and the factor count; an empty row
// hashes the empty vector.  A row with n < 0 or n > 32 * n_words gets count -1
// and zero hashes.
//
// Design: one thread per row.  Its start words come four at a time into
// registers (one 16-byte load where the rows are 16-byte aligned and W is a
// multiple of 4, else a 4-byte load for each word below n), bits at or past
// n and bit 0 cleared as they arrive.  Factor starts are popped two at a
// time, lowest first, from the current word (__ffs, then clear the lowest
// bit), and their two lengths go into one murmur block update
// (Murmur64::add_pair), so no factor takes a parity branch; the lengths
// never reach memory.  The TPU kernel built 64-bit arithmetic from
// u32 pairs and picked words with select chains; neither is needed here.  It
// stays a kernel of its own, apart from factor_words.cu, so that each remains
// a parity point.
//
// What bounds it on the card: a row's murmur block updates are serial, one
// for every two factors, and a warp runs as many as the row of its 32 with
// the most factors; the words (16 bytes a row for windows of up to 128) and
// the outputs are read and written once, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;

// The start bits of a row of n positions in n_words words, popped lowest
// first from `cur`, the bits of word k not yet popped.  Words arrive four at
// a time (g0..g3): one 16-byte load (kVec), or a 4-byte load for each word
// below n; bits at or past n are cleared as they arrive.
template <bool kVec>
struct StartBits {
  const uint32_t* __restrict__ row;
  int32_t n;
  int32_t k = 0;
  uint32_t cur, g1, g2, g3;

  // `first`: words 0..3 when kVec, loaded before n was known
  __device__ __forceinline__ StartBits(const uint32_t* __restrict__ r, int32_t len, uint4 first)
      : row(r), n(len) {
    if (kVec) {
      set(first);
    } else {
      load();
    }
    cur &= ~1u;  // position 0 starts the first factor
  }

  // Word x's bits below n.
  __device__ __forceinline__ uint32_t keep(int32_t x, uint32_t w) const {
    const int32_t left = n - 32 * x;
    return left >= 32 ? w : left > 0 ? w & ((1u << left) - 1u) : 0u;
  }

  // Words k..k+3 into cur, g1, g2, g3.
  __device__ __forceinline__ void load() {
    if (kVec) {
      set(*reinterpret_cast<const uint4*>(row + k));
    } else {
      const int32_t used = (n + 31) >> 5;
      set(make_uint4(k < used ? row[k] : 0u, k + 1 < used ? row[k + 1] : 0u,
                     k + 2 < used ? row[k + 2] : 0u, k + 3 < used ? row[k + 3] : 0u));
    }
  }

  __device__ __forceinline__ void set(uint4 w) {
    cur = keep(k, w.x);
    g1 = keep(k + 1, w.y);
    g2 = keep(k + 2, w.z);
    g3 = keep(k + 3, w.w);
  }

  // The lowest start not yet popped, cleared; n when none is left.
  __device__ __forceinline__ int32_t pop() {
    while (cur == 0) {
      if (32 * (k + 1) >= n) return n;
      ++k;
      const int32_t x = k & 3;
      if (x == 0) {
        load();
      } else {
        cur = x == 1 ? g1 : x == 2 ? g2 : g3;
      }
    }
    const int32_t p = 32 * k + __ffs(static_cast<int>(cur)) - 1;
    cur &= cur - 1u;
    return p;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hash_words_kernel(const uint32_t* __restrict__ words, int32_t n_words,
                  const int32_t* __restrict__ lengths, int64_t n_rows, uint64_t seed,
                  uint64_t* __restrict__ h1_out, uint64_t* __restrict__ h2_out,
                  int32_t* __restrict__ count_out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  const uint32_t* __restrict__ row = words + b * n_words;
  // with 16-byte loads a row holds at least 4 words: the first group's load
  // goes out beside the length's
  const uint4 first = kVec ? *reinterpret_cast<const uint4*>(row) : make_uint4(0, 0, 0, 0);
  const int32_t n = lengths[b];
  if (n < 0 || static_cast<int64_t>(n) > 32ll * n_words) {
    h1_out[b] = 0;
    h2_out[b] = 0;
    count_out[b] = -1;
    return;
  }
  fpmash::Murmur64 hash(seed);
  StartBits<kVec> starts(row, n, first);
  for (int32_t pos = 0; pos < n;) {
    const int32_t a = starts.pop();
    if (a >= n) {
      hash.add(static_cast<uint64_t>(n - pos));
      break;
    }
    const int32_t c = starts.pop();
    hash.add_pair(static_cast<uint64_t>(a - pos), static_cast<uint64_t>(c - a));
    pos = c;
  }
  hash.finish();
  h1_out[b] = hash.h1;
  h2_out[b] = hash.h2;
  count_out[b] = hash.count;
}

}  // namespace

extern "C" int fpmash_hash_words(const void* words, int32_t n_words, const void* lengths,
                                 int64_t n_rows, uint64_t seed, void* h1, void* h2,
                                 void* count, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  // every row's groups 16-byte aligned
  const bool vec = n_words % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  auto kernel = vec ? hash_words_kernel<true> : hash_words_kernel<false>;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(lengths),
      n_rows, seed, static_cast<uint64_t*>(h1), static_cast<uint64_t*>(h2),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
