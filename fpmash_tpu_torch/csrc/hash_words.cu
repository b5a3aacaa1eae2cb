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
// Design: one thread per row walks its set bits in ascending order (__ffs on
// each word, then clear the lowest bit) and feeds each gap straight into the
// 64-bit murmur block update, so lengths never reach memory.  The TPU kernel
// built 64-bit arithmetic from u32 pairs and picked words with select chains;
// neither is needed here.  It stays a kernel of its own, apart from
// factor_words.cu, so that each remains a parity point.
//
// What bounds it on the card: reading the words (16 bytes a row for windows of
// up to 128) and one murmur update per factor; both are small next to
// factor_words.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

__global__ void hash_words_kernel(const uint32_t* __restrict__ words, int32_t n_words,
                                  const int32_t* __restrict__ lengths, int64_t n_rows,
                                  uint64_t seed, uint64_t* __restrict__ h1_out,
                                  uint64_t* __restrict__ h2_out,
                                  int32_t* __restrict__ count_out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  const int32_t n = lengths[b];
  if (n < 0 || static_cast<int64_t>(n) > 32ll * n_words) {
    h1_out[b] = 0;
    h2_out[b] = 0;
    count_out[b] = -1;
    return;
  }
  const uint32_t* __restrict__ row = words + b * n_words;
  fpmash::Murmur64 hash(seed);
  if (n > 0) {
    int32_t prev = 0;
    const int32_t used = (n + 31) >> 5;
    for (int32_t w = 0; w < used; ++w) {
      uint32_t bits = row[w];
      if (w == 0) bits &= ~1u;  // position 0 starts the first factor
      const int32_t left = n - 32 * w;
      if (left < 32) bits &= (1u << left) - 1u;  // no cut at or past n
      while (bits) {
        const int32_t pos = 32 * w + __ffs(static_cast<int>(bits)) - 1;
        hash.add(static_cast<uint64_t>(pos - prev));
        prev = pos;
        bits &= bits - 1u;
      }
    }
    hash.add(static_cast<uint64_t>(n - prev));
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
  constexpr int kThreads = 256;
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  hash_words_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(lengths),
      n_rows, seed, static_cast<uint64_t*>(h1), static_cast<uint64_t*>(h2),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
