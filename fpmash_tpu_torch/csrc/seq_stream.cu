// The record stream of a FASTA or FASTQ file, built from the file's bytes on
// the card: the sequence bytes of its records in order, k - 1 NUL bytes
// between records, and each record's length.
//
// Replaces no Pallas kernel: the JAX package parses a query file on the host
// (fpio_parse_seq, native/fpio.cpp) and ships the joined sequences.  This
// kernel reads the records as that parser does, from the raw bytes, so the
// query of screen and taxscreen crosses the bus as the file, in pinned chunks
// that overlap the read (device.file_to_device), and no host step touches a
// record.  ops/seq_stream.py holds the wrapper and the plain version.
//
// What it reads (data: the file after its leading '\n', '\r' and ' ' bytes;
// the format is the first byte's, as fpio_parse_seq decides it):
//   lines end at '\n'; a last line with no '\n' is a line; a line that would
//   start at the end of the data does not exist and is empty;
//   FASTQ (data[0] == '@'): record r is lines 4r .. 4r + 3, its sequence line
//   4r + 1; the records end at the first r whose line 4r is missing or does
//   not begin with '@' (the parser's break);
//   FASTA: a line that begins with '>' opens a record, every other line is
//   sequence of the last record opened; nothing is read unless data[0] is '>';
//   a sequence line loses one trailing '\r'.
//
// What bounds it: bytes.  At the benchmark's 315 MB FASTQ (1 000 000 reads of
// 150 bases) it reads the file once and writes a 170 MB stream and 8 MB of
// lengths: 0.15 ms at 3.35 TB/s.  Its input takes about 8 ms to cross the bus
// pinned and 30 ms to read from the page cache, so the kernel only has to
// stay far below that; it is built for simplicity, over a few passes rather
// than one: 2.1 ms through the wrapper on an H100 (700 W), 7 % of the bound.
//
// Design: tiles of 4 096 bytes (a block of 256 threads, one 16-byte load a
// thread) and of 1 024 lines, with prefix sums over tiles in one block.
//   1. newlines: each tile's count of '\n' (__vcmpeq4 masks), then their
//      exclusive sums: tile t's first line is the count before it.  The
//      wrapper reads the total, the number of lines less one, and sizes the
//      line arrays.
//   2. lines: each '\n' writes where the next line starts; a FASTQ line 4r
//      that is missing or not '@' lowers the record count (atomicMin).  Then
//      each line's sequence length (0 where it holds none) and whether it is
//      a FASTA header, summed a tile of lines; the sums' prefixes; and each
//      line's offset in the stream (the sequence before it plus k - 1 for
//      each record before its own) and each record's first offset.
//   3. copy: every byte finds its line from its tile's first line and the
//      newlines before it in the tile, and goes to the line's offset in the
//      stream if it is sequence; a thread a record writes its length and the
//      k - 1 NUL bytes before it.  The wrapper reads the record count and the
//      sequence total before it, to size the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                              // bytes a thread: one 16-byte load
constexpr int64_t kTile = kThreads * kPer;            // bytes a block: 4 096
constexpr int kLinesPer = 4;                          // lines a thread
constexpr int64_t kLineTile = kThreads * kLinesPer;   // lines a block: 1 024
constexpr int kScanThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

// Exclusive prefix sum of one value a thread over the block; *total gets the
// block's sum.  Every thread of the block must call it.
template <int N>
__device__ __forceinline__ int64_t block_exclusive(int64_t v, int64_t* total) {
  __shared__ int64_t warp_sum[N / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t s = lane < N / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(kAll, s, d);
      if (lane >= d) s += y;
    }
    if (lane < N / 32) warp_sum[lane] = s;
  }
  __syncthreads();
  const int64_t before = (warp ? warp_sum[warp - 1] : 0) + x - v;
  *total = warp_sum[N / 32 - 1];
  __syncthreads();  // read before the next call writes warp_sum
  return before;
}

// A thread's 16 bytes at p (p a multiple of 16, data 16-byte aligned) as
// four little-endian words; zero past n, which is no newline.
__device__ __forceinline__ void load16(const uint8_t* data, int64_t n, int64_t p,
                                       uint32_t (&w)[4]) {
  if (p + kPer <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(data + p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0;
  for (int64_t q = p; q < n; ++q) w[(q - p) >> 2] |= uint32_t(data[q]) << (8 * ((q - p) & 3));
}

__device__ __forceinline__ uint8_t byte_of(const uint32_t (&w)[4], int i) {
  return static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
}

// Bit i set where byte i of the 16 is '\n'.
__device__ __forceinline__ uint32_t newline_mask(const uint32_t (&w)[4]) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t eq = __vcmpeq4(w[i], 0x0a0a0a0au);  // 0xff in each byte that matches
    m |= (((eq >> 7) & 1u) | ((eq >> 14) & 2u) | ((eq >> 21) & 4u) | ((eq >> 28) & 8u)) << (4 * i);
  }
  return m;
}

// Line j's length less one trailing '\r' (line_start[j + 1] - 1 is its '\n',
// or the end of the data for the last line).
__device__ __forceinline__ int64_t line_length(const uint8_t* data, const int64_t* line_start,
                                               int64_t j) {
  const int64_t s = line_start[j], e = line_start[j + 1] - 1;
  const int64_t len = e - s;
  return len > 0 && data[e - 1] == '\r' ? len - 1 : len;
}

__device__ __forceinline__ bool fasta_header(const uint8_t* data, int64_t n,
                                             const int64_t* line_start, int64_t j) {
  const int64_t s = line_start[j];
  return s < n && data[s] == '>';
}

__global__ void __launch_bounds__(kThreads)
    seq_count_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t* __restrict__ tile_nl) {
  const int64_t p = blockIdx.x * kTile + threadIdx.x * kPer;
  uint32_t w[4];
  load16(data, n, p, w);
  int64_t total;
  block_exclusive<kThreads>(__popc(newline_mask(w)), &total);
  if (threadIdx.x == 0) tile_nl[blockIdx.x] = total;
}

// Exclusive prefix sums in place of m values, the total at [m]; block 0 of
// the launch scans a, block 1 b.
__global__ void __launch_bounds__(kScanThreads)
    seq_scan_kernel(int64_t* __restrict__ a, int64_t* __restrict__ b, int64_t m) {
  int64_t* v = blockIdx.x ? b : a;
  const int64_t per = (m + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per < m ? threadIdx.x * per : m;
  const int64_t hi = lo + per < m ? lo + per : m;
  int64_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += v[i];
  int64_t total;
  int64_t run = block_exclusive<kScanThreads>(sum, &total);
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t x = v[i];
    v[i] = run;
    run += x;
  }
  if (threadIdx.x == 0) v[m] = total;
}

__global__ void __launch_bounds__(kThreads)
    seq_lines_kernel(const uint8_t* __restrict__ data, int64_t n,
                     const int64_t* __restrict__ tile_nl, int64_t n_lines,
                     int64_t* __restrict__ line_start, unsigned long long* records) {
  const int64_t p = blockIdx.x * kTile + threadIdx.x * kPer;
  uint32_t w[4];
  load16(data, n, p, w);
  uint32_t m = newline_mask(w);
  int64_t total;
  int64_t j = tile_nl[blockIdx.x] + block_exclusive<kThreads>(__popc(m), &total);
  const bool fastq = data[0] == '@';
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    const int64_t s = p + i + 1;  // the next line starts here
    line_start[++j] = s;
    if (fastq && (j & 3) == 0 && (s >= n || data[s] != '@'))
      atomicMin(records, static_cast<unsigned long long>(j >> 2));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    line_start[0] = 0;
    line_start[n_lines] = n + 1;  // so the last line ends at n
  }
}

__global__ void __launch_bounds__(kThreads)
    seq_line_sums_kernel(const uint8_t* __restrict__ data, int64_t n,
                         const int64_t* __restrict__ line_start, int64_t n_lines,
                         const int64_t* __restrict__ meta, int64_t* __restrict__ seq_len,
                         int64_t* __restrict__ blk_seq, int64_t* __restrict__ blk_head) {
  const bool fastq = data[0] == '@', fasta = data[0] == '>';
  const int64_t records = fastq ? meta[0] : 0;
  const int64_t j0 = blockIdx.x * kLineTile + threadIdx.x * kLinesPer;
  int64_t seq = 0, heads = 0;
#pragma unroll
  for (int q = 0; q < kLinesPer; ++q) {
    const int64_t j = j0 + q;
    if (j >= n_lines) break;
    int64_t len = 0;
    if (fastq) {
      if ((j & 3) == 1 && (j >> 2) < records) len = line_length(data, line_start, j);
    } else if (fasta_header(data, n, line_start, j)) {
      ++heads;
    } else if (fasta) {
      len = line_length(data, line_start, j);
    }
    seq_len[j] = len;
    seq += len;
  }
  int64_t total;
  block_exclusive<kThreads>(seq, &total);
  if (threadIdx.x == 0) blk_seq[blockIdx.x] = total;
  block_exclusive<kThreads>(heads, &total);
  if (threadIdx.x == 0) blk_head[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    seq_line_apply_kernel(const uint8_t* __restrict__ data, int64_t n,
                          const int64_t* __restrict__ line_start, int64_t n_lines,
                          const int64_t* __restrict__ seq_len, const int64_t* __restrict__ blk_seq,
                          const int64_t* __restrict__ blk_head, int64_t n_blocks, int k,
                          int64_t* __restrict__ meta, int64_t* __restrict__ out_off,
                          int64_t* __restrict__ starts) {
  const bool fastq = data[0] == '@', fasta = data[0] == '>';
  const int64_t records = fastq ? meta[0] : 0;
  const int64_t j0 = blockIdx.x * kLineTile + threadIdx.x * kLinesPer;
  int64_t len[kLinesPer];
  bool head[kLinesPer];
  int64_t seq = 0, heads = 0;
#pragma unroll
  for (int q = 0; q < kLinesPer; ++q) {
    const int64_t j = j0 + q;
    const bool in = j < n_lines;
    len[q] = in ? seq_len[j] : 0;
    head[q] = in && !fastq && fasta_header(data, n, line_start, j);
    seq += len[q];
    heads += head[q];
  }
  int64_t total;
  int64_t before = blk_seq[blockIdx.x] + block_exclusive<kThreads>(seq, &total);
  int64_t opened = blk_head[blockIdx.x] + block_exclusive<kThreads>(heads, &total);
#pragma unroll
  for (int q = 0; q < kLinesPer; ++q) {
    const int64_t j = j0 + q;
    if (j >= n_lines) break;
    opened += head[q];
    const int64_t rec = fastq ? j >> 2 : opened - 1;
    out_off[j] = before + (k - 1) * rec;
    if (fastq ? (j & 3) == 0 && rec < records : head[q] && fasta) starts[rec] = before;
    before += len[q];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    meta[1] = blk_seq[n_blocks];
    if (!fastq) meta[0] = fasta ? blk_head[n_blocks] : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    seq_copy_kernel(const uint8_t* __restrict__ data, int64_t n,
                    const int64_t* __restrict__ tile_nl, const int64_t* __restrict__ line_start,
                    const int64_t* __restrict__ seq_len, const int64_t* __restrict__ out_off,
                    const int64_t* __restrict__ starts, const int64_t* __restrict__ meta, int k,
                    uint8_t* __restrict__ out, int64_t* __restrict__ lengths) {
  const int64_t p = blockIdx.x * kTile + threadIdx.x * kPer;
  uint32_t w[4];
  load16(data, n, p, w);
  const uint32_t m = newline_mask(w);
  int64_t total;
  int64_t j = tile_nl[blockIdx.x] + block_exclusive<kThreads>(__popc(m), &total);
  if (p < n) {
    int64_t len = seq_len[j], from = line_start[j], to = out_off[j];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t q = p + i;
      if (q >= n) break;
      if (q - from < len) out[to + (q - from)] = byte_of(w, i);
      if ((m >> i) & 1u) {
        ++j;  // line j starts at q + 1, and exists
        len = seq_len[j], from = line_start[j], to = out_off[j];
      }
    }
  }
  const int64_t records = meta[0], seq_total = meta[1];
  for (int64_t r = blockIdx.x * int64_t{kThreads} + threadIdx.x; r < records;
       r += int64_t{gridDim.x} * kThreads) {
    const int64_t at = starts[r];
    lengths[r] = (r + 1 < records ? starts[r + 1] : seq_total) - at;
    if (r > 0) {
      uint8_t* sep = out + at + int64_t{k - 1} * (r - 1);
      for (int i = 0; i < k - 1; ++i) sep[i] = 0;
    }
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Each tile's first line, exclusive sums of the tiles' '\n' counts, into
// tile_nl[0 .. tiles], the number of newlines at [tiles].
extern "C" int fpmash_seq_newlines(const void* data, int64_t n, void* tile_nl, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(data) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t tiles = tiles_of(n);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* nl = static_cast<int64_t*>(tile_nl);
  seq_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), n, nl);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  seq_scan_kernel<<<1, kScanThreads, 0, s>>>(nl, nullptr, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The lines of the data: line_start[0 .. n_lines] (n + 1 at the end), each
// line's sequence length and offset in the stream, each record's first
// offset (starts), and meta = {records, sequence bytes}.  meta[0] holds
// ceil(n_lines / 4) on entry; blk holds 2 (ceil(n_lines / 1 024) + 1) values.
extern "C" int fpmash_seq_lines(const void* data, int64_t n, const void* tile_nl, int64_t n_lines,
                                void* line_start, void* meta, void* seq_len, void* blk,
                                void* out_off, void* starts, int k, void* stream) {
  if (n <= 0 || n_lines <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(data) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t tiles = tiles_of(n), blocks = (n_lines + kLineTile - 1) / kLineTile;
  if (tiles > 0x7fffffff || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* ls = static_cast<int64_t*>(line_start);
  auto* mt = static_cast<int64_t*>(meta);
  auto* blk_seq = static_cast<int64_t*>(blk);
  auto* blk_head = blk_seq + blocks + 1;
  seq_lines_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      d, n, static_cast<const int64_t*>(tile_nl), n_lines, ls,
      reinterpret_cast<unsigned long long*>(mt));
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  seq_line_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      d, n, ls, n_lines, mt, static_cast<int64_t*>(seq_len), blk_seq, blk_head);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  seq_scan_kernel<<<2, kScanThreads, 0, s>>>(blk_seq, blk_head, blocks);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  seq_line_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      d, n, ls, n_lines, static_cast<const int64_t*>(seq_len), blk_seq, blk_head, blocks, k, mt,
      static_cast<int64_t*>(out_off), static_cast<int64_t*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// The stream (sized by the wrapper from meta) and the records' lengths.
extern "C" int fpmash_seq_copy(const void* data, int64_t n, const void* tile_nl,
                               const void* line_start, const void* seq_len, const void* out_off,
                               const void* starts, const void* meta, int k, void* out,
                               void* lengths, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(data) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t tiles = tiles_of(n);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  seq_copy_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const int64_t*>(tile_nl),
      static_cast<const int64_t*>(line_start), static_cast<const int64_t*>(seq_len),
      static_cast<const int64_t*>(out_off), static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(meta), k, static_cast<uint8_t*>(out),
      static_cast<int64_t*>(lengths));
  return static_cast<int>(cudaGetLastError());
}
