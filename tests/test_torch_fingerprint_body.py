"""Port: a numpy model of the steps of ``csrc/fingerprint.cu`` (K1, K13) vs the plain versions.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- the block's span
and its cap, the span staged in 16-byte chunks at 16-byte aligned addresses
(the head and tail chunks byte by byte, nothing outside the array read),
dna16 mapped once a word at staging (the code from bits 1-2, checked against
its letter by a byte permute and a per-byte compare), the device-memory
route for blocks whose span does not fit (dna16 mapped at the read), the
flat Duval loop, factor starts in four registers hashed after the loop two
lengths a block update (windows up to 128) or each length hashed as it is
emitted (longer windows), and windows outside their array -- is held
exactly against ``ops/fused_cuda``'s plain versions, against the JAX
package's Pallas kernels in interpret mode (``fingerprint_hashes_fused``,
both variants and both packs) and against its split XLA route
(``cfl_lengths_onehot`` + ``murmur3_u64_batch``).  ``chip_smoke.py`` counts
the Duval steps a character with :func:`fingerprint_model`.  JAX is imported
inside the tests that use it only.
"""

from __future__ import annotations

import struct
from collections import Counter

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models.fingerprint import window_stream
from fpmash_tpu_torch.ops import fused_cuda
from fpmash_tpu_torch.scalar.lyndon import cfl
from fpmash_tpu_torch.scalar.murmur3 import murmur3_x64_128

REG_WIDTH, STREAM_SLACK, ROW_STAGE_WIDTH = 128, 2048, 128  # kRegWidth, kStreamSlack, kRowStageWidth
M32, M64 = 0xFFFFFFFF, (1 << 64) - 1
C1, C2 = 0x87C37B91114253D5, 0x4CF5AD432745937F


def align16(x: int) -> int:
    return (x + 15) & ~15


# ---------------------------------------------------------------------- #
# the device intrinsics and the packs
# ---------------------------------------------------------------------- #


def byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm(x, y, s)``: byte n is byte ``(s >> 4n) & 7`` of ``y:x``."""
    out = 0
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= (((y if sel >= 4 else x) >> (8 * (sel & 3))) & 0xFF) << (8 * n)
    return out


def vcmpeq4(a: int, b: int) -> int:
    """``__vcmpeq4``: 0xFF in each byte where the bytes are equal."""
    return sum(0xFF << (8 * n) for n in range(4) if (a >> (8 * n)) & 0xFF == (b >> (8 * n)) & 0xFF)


def ffs(x: int) -> int:
    return (x & -x).bit_length()


def raw_word(x: int) -> int:
    return x


def dna16_word(x: int) -> int:
    """``Dna16Codes`` on four bytes: C G T -> 1 2 3, any other byte -> 0."""
    c = ((x >> 1) & 0x03030303) ^ ((x >> 2) & 0x01010101)
    sel = (c & 0x3) | ((c >> 4) & 0x30) | ((c >> 8) & 0x300) | ((c >> 12) & 0x3000)
    return c & vcmpeq4(x, byte_perm(0x54474341, 0, sel))


CODES = {"byte4": raw_word, "dna16": dna16_word}


# ---------------------------------------------------------------------- #
# MurmurHash3 fed one value, or two, at a time (murmur3.cuh)
# ---------------------------------------------------------------------- #


def rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & M64
    return k ^ (k >> 33)


def mix_k1(k1: int) -> int:
    return (rotl64((k1 * C1) & M64, 31) * C2) & M64


def mix_k2(k2: int) -> int:
    return (rotl64((k2 * C2) & M64, 33) * C1) & M64


class Murmur64:
    def __init__(self, seed: int):
        self.h1 = self.h2 = seed & M64
        self.k1, self.count = 0, 0

    def block(self, k1: int, k2: int) -> None:
        h1 = self.h1 ^ mix_k1(k1)
        h1 = ((rotl64(h1, 27) + self.h2) * 5 + 0x52DCE729) & M64
        h2 = self.h2 ^ mix_k2(k2)
        self.h1, self.h2 = h1, ((rotl64(h2, 31) + h1) * 5 + 0x38495AB5) & M64

    def add(self, v: int) -> None:
        if self.count & 1:
            self.block(self.k1, v)
        else:
            self.k1 = v
        self.count += 1

    def add_pair(self, a: int, b: int) -> None:
        assert self.count % 2 == 0, "add_pair is called on an even count"
        self.block(a, b)
        self.count += 2

    def finish(self) -> None:
        if self.count & 1:
            self.h1 ^= mix_k1(self.k1)
        n = 8 * self.count
        h1, h2 = self.h1 ^ n, self.h2 ^ n
        h1 = (h1 + h2) & M64
        h2 = (h2 + h1) & M64
        h1, h2 = fmix64(h1), fmix64(h2)
        h1 = (h1 + h2) & M64
        self.h1, self.h2 = h1, (h2 + h1) & M64


# ---------------------------------------------------------------------- #
# a block's span, staged
# ---------------------------------------------------------------------- #


def span_cap(threads: int, width: int) -> int:
    """``span_cap``: K1 (width < 0) or K13 rows of ``width``; 0 stages nothing."""
    if width < 0:
        return align16(2 * threads + STREAM_SLACK) + 16
    return align16(threads * width) + 16 if width <= ROW_STAGE_WIDTH else 0


def stage(src: np.ndarray, lo: int, hi: int, cap: int, addr: int, code):
    """The block's shared bytes (mapped by ``code``) and ``g0``, the index of
    staged byte 0, at the 16-byte aligned address at or below ``src[lo]``
    (``addr`` is ``src``'s address); None where the span does not fit.
    Also returns how many chunks were one 16-byte load."""
    if hi < 0:
        return None
    g0 = lo - (addr + lo) % 16
    staged_len = align16(hi - g0)
    if staged_len > cap:
        return None
    smem, vector_loads = bytearray(staged_len), 0
    for ch in range(staged_len // 16):
        q = g0 + 16 * ch
        assert (addr + q) % 16 == 0
        if q >= 0 and q + 16 <= len(src):
            vector_loads += 1
        data = bytes(int(src[q + i]) if 0 <= q + i < len(src) else 0 for i in range(16))
        words = [code(int.from_bytes(data[4 * m : 4 * m + 4], "little")) for m in range(4)]
        smem[16 * ch : 16 * ch + 16] = b"".join(w.to_bytes(4, "little") for w in words)
    return bytes(smem), g0, vector_loads


class Text:
    """A window as the automaton reads it: ``w[x]``."""

    def __init__(self, read):
        self.read = read

    def __getitem__(self, x: int) -> int:
        return self.read(x)


def staged_text(smem: bytes, off: int) -> Text:
    return Text(lambda x: smem[off + x])


def device_text(src: np.ndarray, start: int, code) -> Text:
    return Text(lambda x: code(int(src[start + x])))


# ---------------------------------------------------------------------- #
# the flat Duval loop and the two hash placements
# ---------------------------------------------------------------------- #


class RegBits:
    """``RegBits``: four words set through selects on ``p >> 5``."""

    def __init__(self):
        self.w = [0, 0, 0, 0]

    def set(self, p: int) -> None:
        bit, q = 1 << (p & 31), p >> 5
        self.w = [w | (bit if q == k else 0) for k, w in enumerate(self.w)]

    def pop_lowest(self, none: int) -> int:
        q = next((k for k in range(4) if self.w[k]), 4)
        w = self.w[q] if q < 4 else 0
        self.w = [x & ((x - 1) & M32 if q == k else M32) for k, x in enumerate(self.w)]
        return none if q == 4 else 32 * q + ffs(w) - 1


def duval(w: Text, n: int, emit, steps: Counter) -> None:
    """``duval``: one scan step, or one emitted factor, an iteration."""
    i, j, k = 0, 1, 0
    while i < n:
        steps["duval"] += 1
        inside = j < n
        a, c = (w[k], w[j]) if inside else (0, 0)
        if inside and a <= c:
            k = i if a < c else k + 1
            j += 1
        else:
            emit(i, j - k)
            i += j - k
            if i > k:
                j, k = i + 1, i


def fingerprint_window(w: Text, n: int, seed: int, steps: Counter,
                       reg_width: int = REG_WIDTH) -> tuple[int, int, int]:
    """``fingerprint_window``: ``(h1, h2, count)`` of one valid window."""
    hash_ = Murmur64(seed)
    if n <= reg_width:
        starts = RegBits()
        duval(w, n, lambda i, p: starts.set(i), steps)
        starts.pop_lowest(n)  # start 0
        pos = 0
        while pos < n:
            steps["hash"] += 1
            a = starts.pop_lowest(n)
            if a >= n:
                hash_.add(a - pos)
                break
            b = starts.pop_lowest(n)
            hash_.add_pair(a - pos, b - a)
            pos = b
    else:
        duval(w, n, lambda i, p: hash_.add(p), steps)
    hash_.finish()
    return hash_.h1, hash_.h2, hash_.count


# ---------------------------------------------------------------------- #
# the kernel: blocks of windows
# ---------------------------------------------------------------------- #


def fingerprint_model(src, starts, lengths, seed: int = 42, *, pack: str = "byte4",
                      width: int = -1, threads: int = 256, addr: int = 0,
                      reg_width: int = REG_WIDTH):
    """The kernel's ``(h1, h2, count)`` for each window, step by step: K1
    over ``starts`` (``width < 0``) or K13 over rows of ``width`` (``starts``
    ignored), ``src`` at address ``addr``.  Returns ``(h1 int64[B], h2
    int64[B], count int32[B], steps Counter, routes Counter)``."""
    src = np.asarray(src, np.uint8)
    lengths = np.asarray(lengths, np.int32)
    B, n_src = len(lengths), len(src)
    if width >= 0:
        starts = np.arange(B, dtype=np.int64) * width
    starts = np.asarray(starts, np.int64)
    code = CODES[pack]
    cap = span_cap(threads, width)
    h1, h2 = np.zeros(B, np.uint64), np.zeros(B, np.uint64)
    count = np.full(B, -1, np.int32)
    steps, routes = Counter(), Counter()
    for b0 in range(0, B, threads):
        block = range(b0, min(B, b0 + threads))
        valid = {b: (int(starts[b]) >= 0 and int(lengths[b]) >= 0
                     and int(starts[b]) <= n_src - int(lengths[b])) for b in block}
        spans = [(int(starts[b]), int(starts[b]) + int(lengths[b])) for b in block if valid[b]]
        lo = min((s for s, _ in spans), default=np.iinfo(np.int64).max)
        hi = max((e for _, e in spans), default=-1)
        staged = stage(src, lo, hi, cap, addr, code)
        routes["staged" if staged else "device"] += 1
        if staged:
            routes["vector_loads"] += staged[2]
        for b in block:
            if not valid[b]:
                continue  # zero hashes, count -1: never read
            start, n = int(starts[b]), int(lengths[b])
            w = (staged_text(staged[0], start - staged[1]) if staged
                 else device_text(src, start, code))
            h1[b], h2[b], count[b] = fingerprint_window(w, n, seed, steps, reg_width)
    return h1.view(np.int64), h2.view(np.int64), count, steps, routes


# ---------------------------------------------------------------------- #
# inputs and oracles
# ---------------------------------------------------------------------- #


def _texts(seed: int, lengths, alphabet: bytes) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(alphabet, np.uint8)
    return [lut[rng.integers(0, len(lut), size=int(n))].tobytes() for n in lengths]


def _shift_stream(seed: int, read_lens, alphabet: bytes = b"ACGT"):
    """Shift windows of reads (reads under 100 give one window of themselves),
    as models/sketch.py ships them."""
    texts = [t.decode("latin-1") for t in _texts(seed, read_lens, alphabet)]
    flat, starts, lengths, _ = window_stream(texts, shift=True)
    return flat, starts, lengths


def _plain_stream(flat, starts, lengths, seed=42):
    got = fused_cuda.fingerprint_hashes_plain(torch.from_numpy(np.ascontiguousarray(flat)),
                                              torch.from_numpy(starts), torch.from_numpy(lengths),
                                              seed)
    return tuple(g.numpy() for g in got)


def _assert_stream_model_equals_plain(flat, starts, lengths, seed=42, **kw):
    h1, h2, count, steps, routes = fingerprint_model(flat, starts, lengths, seed, **kw)
    want = _plain_stream(flat, starts, lengths, seed)
    for got, w, what in zip((h1, h2, count), want, ("h1", "h2", "count")):
        bad = np.flatnonzero(got != w)
        assert not len(bad), f"{what}: windows {bad[:8]} differ from the plain version"
    return steps, routes


def _rows(words: list[bytes], width: int):
    arr = np.zeros((len(words), width), np.uint8)
    for i, w in enumerate(words):
        arr[i, : len(w)] = np.frombuffer(w, np.uint8)
    return arr, np.array([len(w) for w in words], np.int32)


def _assert_rows_model_equals_plain(arr, lens, pack, seed=42, **kw):
    h1, h2, count, steps, routes = fingerprint_model(arr.reshape(-1), None, lens, seed,
                                                     pack=pack, width=arr.shape[1], **kw)
    want = fused_cuda.fingerprint_hashes_fused_plain(torch.from_numpy(arr),
                                                     torch.from_numpy(lens), seed, pack)
    for got, w in zip((h1, h2, count), want):
        assert np.array_equal(got, w.numpy()), pack
    return steps, routes


# ---------------------------------------------------------------------- #
# the steps, one by one
# ---------------------------------------------------------------------- #


def test_dna16_word_map_for_every_byte():
    """The staging map equals the plain version's ``_packed_rows`` on every
    byte, alone and four to a word."""
    every = torch.arange(256, dtype=torch.uint8).reshape(1, -1)
    want = fused_cuda._packed_rows(every, "dna16").reshape(-1).tolist()
    assert [dna16_word(u) for u in range(256)] == want
    rng = np.random.default_rng(0)
    for x in rng.integers(0, 1 << 32, size=2000, dtype=np.uint64).tolist():
        got = dna16_word(int(x)).to_bytes(4, "little")
        assert list(got) == [want[b] for b in int(x).to_bytes(4, "little")]
    assert dna16_word(int.from_bytes(b"ACGT", "little")) == 0x03020100
    assert dna16_word(int.from_bytes(b"NcgT", "little")) == 0x03000000


@pytest.mark.parametrize("addr", [0, 1, 7, 15])
@pytest.mark.parametrize("lo,hi", [(0, 100), (3, 357), (17, 17), (1000, 1460), (1400, 1470)])
def test_staged_span_head_and_tail(addr, lo, hi):
    """Staged byte x is ``code(src[g0 + x])``, ``src + g0`` is 16-byte
    aligned, bytes outside the array stage as 0 and are loaded byte by
    byte, interior chunks are single 16-byte loads."""
    rng = np.random.default_rng(lo + hi + addr)
    src = np.frombuffer(b"ACGTNacgt\x00\xff", np.uint8)[rng.integers(0, 11, size=1470)]
    cap = span_cap(256, -1)
    for pack, code in CODES.items():
        smem, g0, vector_loads = stage(src, lo, hi, cap, addr, code)
        assert g0 <= lo and (addr + g0) % 16 == 0 and g0 + len(smem) >= hi
        assert len(smem) <= cap and len(smem) % 16 == 0
        mapped = fused_cuda._packed_rows(torch.from_numpy(src).reshape(1, -1), pack)[0].numpy()
        assert list(smem[lo - g0 : hi - g0]) == mapped[lo:hi].tolist()
        outside = [x for x in range(len(smem)) if not 0 <= g0 + x < len(src)]
        assert all(smem[x] == 0 for x in outside)
        inside_chunks = sum(1 for ch in range(len(smem) // 16)
                            if g0 + 16 * ch >= 0 and g0 + 16 * ch + 16 <= len(src))
        assert vector_loads == inside_chunks >= len(smem) // 16 - 2


def test_span_caps():
    """K1's cap takes 256 shift windows of up to 1 024 characters; K13 stages
    rows of up to 128, whose block is ``T * L`` bytes however misaligned."""
    assert span_cap(256, -1) >= align16(256 + 2 * 1023 + 15)
    for width in (0, 1, 99, 100, 128):
        for threads in (32, 256):
            assert span_cap(threads, width) >= align16(threads * width + 15)
    assert span_cap(256, 129) == 0 and span_cap(32, 1000) == 0


def test_reg_bits_pop_lowest_walks_the_starts_upward():
    rng = np.random.default_rng(3)
    for _ in range(50):
        ps = sorted(set(rng.integers(0, 128, size=int(rng.integers(1, 40))).tolist()))
        bits = RegBits()
        for p in ps:
            bits.set(p)
        assert [bits.pop_lowest(999) for _ in range(len(ps) + 2)] == ps + [999, 999]


def _factor_lengths(text: bytes, reg_width: int) -> list[int]:
    """The lengths the kernel hashes for ``text``, in order."""
    got = []
    if len(text) <= reg_width:
        bits = RegBits()
        duval(Text(lambda x: text[x]), len(text), lambda i, p: bits.set(i), Counter())
        pos = bits.pop_lowest(len(text))
        while pos < len(text):
            nxt = bits.pop_lowest(len(text))
            got.append(nxt - pos)
            pos = nxt
    else:
        duval(Text(lambda x: text[x]), len(text), lambda i, p: got.append(p), Counter())
    return got


@pytest.mark.parametrize("reg_width", [REG_WIDTH, 0])
def test_flat_duval_gives_the_scalar_cfl(reg_width):
    """Both hash placements see the scalar Duval factor lengths, in order."""
    texts = _texts(4, [1, 2, 5, 31, 99, 100, 127, 128, 129, 300], b"ACGTN\x80\xff")
    texts += [b"A" * 100, b"ACGT" * 25, b"T" * 99 + b"A", b"CA", b"AC" * 70, b""]
    for t in texts:
        want = [len(f) for f in cfl(t.decode("latin-1"))]
        assert _factor_lengths(t, reg_width) == want, t


@pytest.mark.parametrize("seed", [42, 7, (1 << 64) - 1])
def test_pairwise_and_inline_hashing_equal_murmur3(seed):
    """Two lengths a block update after the loop, and one at a time as
    emitted, both give MurmurHash3 of the u64 image (odd counts too)."""
    for t in _texts(5, [0, 1, 2, 3, 17, 64, 100, 128], b"ACGT") + [b"AC" * 64, b"A" * 128]:
        vec = [len(f) for f in cfl(t.decode())]
        want = (*murmur3_x64_128(b"".join(struct.pack("<Q", v) for v in vec), seed), len(vec))
        for reg_width in (REG_WIDTH, 0):
            got = fingerprint_window(Text(lambda x: t[x]), len(t), seed, Counter(), reg_width)
            assert got == want, (t, reg_width)


# ---------------------------------------------------------------------- #
# the whole kernel against the plain versions
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("threads", [32, 64])
def test_model_matches_plain_on_shift_windows(threads):
    """Shift windows of reads of 150-260 bases (windows across block edges,
    read boundaries inside blocks), reads under 100 bases and a read of
    length 1, all staged; with N and bytes of 0x80 and above."""
    flat, starts, lengths = _shift_stream(11, [150, 99, 1, 260, 40, 100, 2, 177],
                                          b"ACGTN\x80\xfe")
    steps, routes = _assert_stream_model_equals_plain(flat, starts, lengths, threads=threads)
    assert routes["device"] == 0 and routes["staged"] == -(-len(starts) // threads)
    assert {1, 2, 40, 99, 100} <= set(lengths.tolist())


@pytest.mark.parametrize("addr", [1, 9])
def test_model_matches_plain_on_an_unaligned_stream(addr):
    """The stream at an address that is not 16-byte aligned (``flat[1:]``)."""
    flat, starts, lengths = _shift_stream(12, [230, 120], b"ACGT")
    steps, routes = _assert_stream_model_equals_plain(flat, starts, lengths, threads=32,
                                                      addr=addr)
    assert routes["device"] == 0 and routes["vector_loads"] > 0


def test_model_matches_plain_over_the_cap():
    """Spans over the cap read device memory: shuffled starts of a long
    stream, whole reads of 300-2 400 bases (``shift=False``) whose windows
    hash each length as it is emitted, and a block mixing both."""
    flat, starts, lengths = _shift_stream(13, [1500, 1400], b"ACGT")
    rng = np.random.default_rng(13)
    order = rng.permutation(len(starts))[:96]
    _, routes = _assert_stream_model_equals_plain(flat, starts[order], lengths[order], threads=32)
    assert routes["device"] == 3 and routes["staged"] == 0
    texts = _texts(14, [300, 2400, 129, 128, 1000, 5], b"ACGTN")
    flat = np.frombuffer(b"".join(texts), np.uint8).copy()
    starts = np.cumsum([0] + [len(t) for t in texts[:-1]]).astype(np.int64)
    lengths = np.array([len(t) for t in texts], np.int32)
    steps, routes = _assert_stream_model_equals_plain(flat, starts, lengths, threads=32)
    assert routes["device"] == 1
    steps, routes = _assert_stream_model_equals_plain(flat, starts[2:4], lengths[2:4], threads=32)
    assert routes["staged"] == 1  # windows of 129 and 128 fit


def test_model_flags_windows_outside_the_stream():
    """Empty windows (at the end too), B = 1, and windows outside the stream,
    in staged and unstaged blocks: zero hashes and count -1, never read."""
    flat = np.frombuffer(b"ACGTTGCAAC", np.uint8).copy()
    starts = np.array([0, 3, -1, 10, 2, 9, 11, 0, 8], np.int64)
    lengths = np.array([10, 8, 1, 0, -2, 1, 0, 0, 2], np.int32)
    _assert_stream_model_equals_plain(flat, starts, lengths, threads=32)
    h1, h2, count, _, _ = fingerprint_model(flat, starts, lengths, threads=32)
    n_cfl = len(cfl("ACGTTGCAAC"))
    assert count.tolist() == [n_cfl, -1, -1, 0, -1, 1, -1, 0, len(cfl("AC"))]
    assert h1[[1, 2, 4, 6]].tolist() == [0] * 4 and h2[[1, 2, 4, 6]].tolist() == [0] * 4
    for b in range(len(starts)):  # B = 1
        _assert_stream_model_equals_plain(flat, starts[b : b + 1], lengths[b : b + 1])
    _, routes = _assert_stream_model_equals_plain(flat, starts[[2, 4, 6]], lengths[[2, 4, 6]])
    assert routes == Counter(device=1)  # no window inside: nothing staged


@pytest.mark.parametrize("pack", ["byte4", "dna16"])
def test_model_matches_plain_on_rows(pack):
    """K13: rows of 100 (B not a multiple of the block, lengths 0, 1 and L,
    N, lower case, bytes of 0x80 and above), at an unaligned address, B = 1,
    and rows wider than the cap (device route, dna16 mapped at the read)."""
    words = _texts(20, [100] * 60 + [0, 1, 37, 99, 100], b"ACGTNacgt\x80\xffRY")
    arr, lens = _rows(words, 100)
    for addr in (0, 3):
        _, routes = _assert_rows_model_equals_plain(arr, lens, pack, threads=32, addr=addr)
        assert routes["staged"] == 3 and routes["device"] == 0
    _assert_rows_model_equals_plain(arr[:1], lens[:1], pack)
    _assert_rows_model_equals_plain(arr[61:62], lens[61:62], pack)
    for width in (129, 300):
        wide, wide_lens = _rows(_texts(21, [width, width - 1, 64, 0, 128, 129], b"ACGTN"),
                                width)
        _, routes = _assert_rows_model_equals_plain(wide, wide_lens, pack, threads=32)
        assert routes == Counter(device=1)
    one, one_lens = _rows([b"G", b"", b"T"], 1)
    _assert_rows_model_equals_plain(one, one_lens, pack, threads=32)


def test_rows_equal_the_stream_of_the_packed_rows():
    """K13 under dna16 equals K1 on the rows' dna16 codes, as the split
    variant ships them."""
    arr, lens = _rows(_texts(22, [100] * 40 + [3, 0], b"ACGTNacgtRY"), 100)
    k13 = fingerprint_model(arr.reshape(-1), None, lens, pack="dna16", width=100, threads=32)
    codes = fused_cuda._packed_rows(torch.from_numpy(arr), "dna16").numpy()
    k1 = fingerprint_model(codes.reshape(-1), np.arange(len(lens)) * 100, lens, threads=32)
    for a, b in zip(k13[:3], k1[:3]):
        assert np.array_equal(a, b)
    # 32 rows of 100 exceed K1's cap at 32 threads; the last 10 fit
    assert (k1[4]["device"], k1[4]["staged"]) == (1, 1)


def test_both_hash_placements_agree_on_the_main_path_shape():
    """Factor starts hashed after the loop and lengths hashed as emitted
    give the same hashes on shift windows of 100."""
    flat, starts, lengths = _shift_stream(23, [400, 300], b"ACGT")
    a = fingerprint_model(flat, starts, lengths, threads=64)
    b = fingerprint_model(flat, starts, lengths, threads=64, reg_width=0)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert a[3]["duval"] == b[3]["duval"] and a[3]["hash"] > 0 and b[3]["hash"] == 0
    # about 1.1 Duval steps a character on random ACGT windows of 100
    assert 1.0 < a[3]["duval"] / int(lengths.sum()) < 1.4


# ---------------------------------------------------------------------- #
# against the JAX package
# ---------------------------------------------------------------------- #


def _jax_rows(seed: int, alphabet: bytes):
    words = _texts(seed, [100] * 36 + [0, 1, 2, 50, 99], alphabet)
    words += [b"A" * 100, b"ACGT" * 25, b"T" * 99 + b"A"]
    return _rows(words, 100)


@pytest.mark.parametrize("pack,alphabet", [("byte4", b"ACGTNacg\x80\xff?"),
                                           ("dna16", b"ACGTNacgtRY")])
@pytest.mark.parametrize("variant", ["inline", "split"])
def test_model_matches_pallas_interpret(pack, alphabet, variant):
    """The model's K13 (inline) and K1 on the packed rows' stream (split)
    against ``fingerprint_hashes_fused`` in interpret mode."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_fused

    arr, lens = _jax_rows(30 if pack == "byte4" else 31, alphabet)
    jh1, jh2, jfc = fingerprint_hashes_fused(jnp.asarray(arr), jnp.asarray(lens), seed=42,
                                             interpret=True, pack=pack, variant=variant)
    if variant == "inline":
        got = fingerprint_model(arr.reshape(-1), None, lens, pack=pack, width=100, threads=32)
    else:
        codes = fused_cuda._packed_rows(torch.from_numpy(arr), pack).numpy()
        got = fingerprint_model(codes.reshape(-1), np.arange(len(lens)) * 100, lens, threads=32)
    assert np.array_equal(got[0].view(np.uint64), np.asarray(jh1))
    assert np.array_equal(got[1].view(np.uint64), np.asarray(jh2))
    assert np.array_equal(got[2], np.asarray(jfc))


def test_model_matches_split_xla_route():
    """vs ``cfl_lengths_onehot`` + ``murmur3_u64_batch`` on shift windows."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.lyndon import cfl_lengths_onehot
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    flat, starts, lengths = _shift_stream(32, [130, 60], b"ACGTN")
    arr, lens = _rows([flat[s : s + n].tobytes() for s, n in zip(starts, lengths)], 100)
    fac_len, fac_count = cfl_lengths_onehot(jnp.asarray(arr), jnp.asarray(lens))
    jh1, jh2 = murmur3_u64_batch(fac_len.astype(jnp.uint64), fac_count, seed=42)
    h1, h2, count, _, _ = fingerprint_model(flat, starts, lengths, threads=32)
    assert np.array_equal(h1.view(np.uint64), np.asarray(jh1))
    assert np.array_equal(h2.view(np.uint64), np.asarray(jh2))
    assert np.array_equal(count, np.asarray(fac_count))
