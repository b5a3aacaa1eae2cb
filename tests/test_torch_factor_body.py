"""Port: a numpy model of the steps of ``csrc/factor_words.cu`` (K3, K14) vs the plain versions.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- the block's span
and its cap, the span staged in chunks of 16 bytes with its reverse
complement beside it (each byte complemented by the byte-permute map), the
rc slice offset, the device-memory route for blocks whose span does not fit,
the Duval loop (one loop for CFL, a scan loop inside an emission loop for
CFL_ICFL), the ICFL scan over an absolute ``st[]`` with ``last`` parked in
``st[old base]`` (one loop, or a scan and a chain loop per level), candidate bits merged from highest to lowest, each
CFL_ICFL segment folded before the next, marks through selects on ``c >> 5``
into four registers or into a shared row marked a strip at a time -- is held
exactly against ``ops/icfl_cuda.factor_words_plain`` and against the JAX
package's Pallas kernels in interpret mode (``icfl_words_fused`` and
``cfl_boundaries_pallas``, composed family by family as
``fpmash_tpu/ops/factorize.py`` composes them).  ``chip_smoke.py`` counts the
automaton steps a character with :func:`factor_words_model`.  JAX is imported
inside the tests that use it only.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models.fingerprint import window_stream
from fpmash_tpu_torch.ops import icfl_cuda
from fpmash_tpu_torch.ops.factorize import COMPLEMENT, FAMILY_PLANS

REG_WIDTH, MAX_ICFL_WIDTH, STRIP_WORDS = 128, 1023, 128  # kRegWidth, kMaxIcflWidth, kStripWords
RC_THRESHOLD = 30
BASES = {"cfl": 0, "icfl": 1, "cfl_icfl": 2}
FAMILIES = tuple(FAMILY_PLANS)
M32 = 0xFFFFFFFF


def align16(x: int) -> int:
    return (x + 15) & ~15


# ---------------------------------------------------------------------- #
# the device intrinsics and the byte map
# ---------------------------------------------------------------------- #


def byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm(x, y, s)``: byte n is byte ``(s >> 4n) & 7`` of ``y:x``."""
    out = 0
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= (((y if sel >= 4 else x) >> (8 * (sel & 3))) & 0xFF) << (8 * n)
    return out


def clz(x: int) -> int:
    return 32 - (x & M32).bit_length()


def complement(u: int) -> int:
    """``complement``: A C G T from bits 1-2, checked against the letter."""
    c = ((u >> 1) & 3) ^ ((u >> 2) & 1)
    sel = 0x4440 | c
    return byte_perm(0x41434754, 0, sel) if u == byte_perm(0x54474341, 0, sel) else ord("N")


def complement_reversed(x: int) -> int:
    return (complement(x >> 24) | complement((x >> 16) & 0xFF) << 8
            | complement((x >> 8) & 0xFF) << 16 | complement(x & 0xFF) << 24)


# ---------------------------------------------------------------------- #
# a block's span, staged
# ---------------------------------------------------------------------- #


def span_cap(threads: int, max_len: int) -> int:
    """``Layout::cap``: the staged span's bytes for a block of ``threads``."""
    return align16(2 * threads + 2 * min(max_len, 1024)) + 16


def stage(flat: np.ndarray, lo: int, hi: int, cap: int):
    """The block's shared bytes ``smem[0, 2 cap)`` with the span at 0 and its
    reverse complement at ``cap``, and ``(span0, staged_len)``; None where the
    span does not fit (the block reads device memory)."""
    span0 = lo & ~15
    staged_len = align16(hi - span0)
    if hi < 0 or staged_len > cap:
        return None
    smem = bytearray(2 * cap)
    for ch in range(staged_len // 16):
        q = span0 + 16 * ch
        x = [0, 0, 0, 0]
        for i in range(16):
            if q + i < len(flat):
                x[i >> 2] |= int(flat[q + i]) << (8 * (i & 3))
        smem[16 * ch : 16 * ch + 16] = b"".join(w.to_bytes(4, "little") for w in x)
        rc = [complement_reversed(x[3]), complement_reversed(x[2]),
              complement_reversed(x[1]), complement_reversed(x[0])]
        at = cap + staged_len - 16 - 16 * ch
        smem[at : at + 16] = b"".join(w.to_bytes(4, "little") for w in rc)
    return bytes(smem), span0, staged_len


class Text:
    """A strand as the automaton reads it: ``read(x)``."""

    def __init__(self, read):
        self.read = read

    def __getitem__(self, x: int) -> int:
        return self.read(x)


def staged_text(smem: bytes, off: int) -> Text:
    return Text(lambda x: smem[off + x])


def device_text(flat: np.ndarray, start: int) -> Text:
    return Text(lambda x: int(flat[start + x]))


def device_rc_text(flat: np.ndarray, start: int, n: int) -> Text:
    return Text(lambda x: complement(int(flat[start + n - 1 - x])))


# ---------------------------------------------------------------------- #
# the marks: four registers or a row of shared memory
# ---------------------------------------------------------------------- #


class RegBits:
    """``RegBits``: four words, each set or cleared through a select on ``p >> 5``."""

    def __init__(self):
        self.w = [0, 0, 0, 0]

    def set(self, p: int) -> None:
        bit, q = 1 << (p & 31), p >> 5
        self.w = [w | (bit if q == k else 0) for k, w in enumerate(self.w)]

    def clear(self, p: int) -> None:
        keep, q = ~(1 << (p & 31)) & M32, p >> 5
        self.w = [w & (keep if q == k else M32) for k, w in enumerate(self.w)]

    def highest(self, below: int, floor: int) -> int:
        for k in (3, 2, 1, 0):
            if self.w[k]:
                return 32 * k + 31 - clz(self.w[k])
        return -1


class RowBits:
    """``RowBits``: positions ``[lo, hi)`` of a row of shared words."""

    def __init__(self, words: list, lo: int, hi: int):
        self.words, self.lo, self.hi = words, lo, hi

    def set(self, p: int) -> None:
        if self.lo <= p < self.hi:
            self.words[(p - self.lo) >> 5] |= 1 << (p & 31)

    def clear(self, p: int) -> None:
        self.words[(p - self.lo) >> 5] &= ~(1 << (p & 31)) & M32

    def highest(self, below: int, floor: int) -> int:
        for q in range((below - 1 - self.lo) >> 5, ((floor - self.lo) >> 5) - 1, -1):
            if self.words[q]:
                return self.lo + 32 * q + 31 - clz(self.words[q])
        return -1


def mark(out, n: int, c: int, rc: bool) -> None:
    if rc:
        if c < 1:
            return
        c = n - c
    out.set(c)


# ---------------------------------------------------------------------- #
# the automatons
# ---------------------------------------------------------------------- #


def icfl_segment(w: Text, n: int, seg0: int, length: int, st: np.ndarray, cand, out, rc: bool,
                 steps: Counter, flat: bool = True) -> None:
    """``icfl_segment``: scan, chain and commit -- in one loop of one step an
    iteration (``flat``) or a scan loop and a chain loop per level -- with
    ``st[]`` by absolute position and ``last`` parked at ``st[old base]``,
    then the merge."""
    base, rem, i, j, b, best, c, chain = seg0, length, 0, 1, 0, 0, 0, False
    while not flat:
        i, j = 0, 1
        while j < rem:
            steps["scan"] += 1
            si, sj = w[base + i], w[base + j]
            st[base + j] = i
            if sj > si:
                c = sj
                break
            i = i + 1 if sj == si else 0
            j += 1
        if j >= rem:
            break
        best = b = i
        while b > 0:
            steps["chain"] += 1
            b = int(st[base + b])
            if w[base + b] < c:
                best = b
        plen = j - best
        st[base] = best
        cand.set(base + plen)
        base += plen
        rem -= plen
    while flat and (chain or j < rem):  # one scan or chain step an iteration
        if not chain:
            steps["scan"] += 1
            si, sj = w[base + i], w[base + j]
            st[base + j] = i
            if sj > si:
                c, b, best, chain = sj, i, i, True
            else:
                i = i + 1 if sj == si else 0
                j += 1
        else:
            steps["chain"] += 1
            b2 = int(st[base + b])
            if w[base + b2] < c:
                best = b2
            b = b2
        if chain and b <= 0:  # commit in the step that ends the chain
            plen = j - best
            st[base] = best
            cand.set(base + plen)
            base += plen
            rem -= plen
            i, j, chain = 0, 1, False
    end = seg0 + length
    pos = cand.highest(end, seg0)
    cur = end - pos
    while pos > seg0:
        steps["merge"] += 1
        cand.clear(pos)
        below = cand.highest(pos, seg0)
        prev = below if below > seg0 else seg0
        plen = pos - prev
        if cur > int(st[prev]):
            mark(out, n, pos, rc)
            cur = plen
        else:
            cur += plen
        pos = prev


def base_pass(kbase: int, w: Text, n: int, threshold: int, st, cand, out, rc: bool,
              steps: Counter) -> None:
    if kbase == BASES["icfl"]:
        if n > 0:
            mark(out, n, 0, rc)
        icfl_segment(w, n, 0, n, st, cand, out, rc, steps)
        return
    if kbase == BASES["cfl"]:
        i, j, k = 0, 1, 0
        while i < n:  # one scan step, or one emitted factor, an iteration
            steps["duval"] += 1
            inside = j < n
            a, c = (w[k], w[j]) if inside else (0, 0)
            if inside and a <= c:
                k = i if a < c else k + 1
                j += 1
            else:
                mark(out, n, i, rc)
                i += j - k
                if i > k:
                    j, k = i + 1, i
        return
    i = 0  # CFL_ICFL: a scan loop inside an emission loop, nested segments
    while i < n:
        j, k = i + 1, i
        while j < n:
            steps["duval"] += 1
            a, c = w[k], w[j]
            if a > c:
                break
            k = i if a < c else k + 1
            j += 1
        p = j - k
        while i <= k:
            mark(out, n, i, rc)
            if p > threshold:
                icfl_segment(w, n, i, p, st, cand, out, rc, steps, flat=False)
            i += p


def window_passes(kbase, fwd, rcw, n, threshold, comb, st, cand, out, steps) -> None:
    base_pass(kbase, fwd, n, threshold, st, cand, out, False, steps)
    if comb:
        rc_threshold = RC_THRESHOLD if kbase == BASES["cfl_icfl"] else threshold
        base_pass(kbase, rcw, n, rc_threshold, st, cand, out, True, steps)


# ---------------------------------------------------------------------- #
# the kernel: blocks of windows
# ---------------------------------------------------------------------- #


def factor_words_model(flat, starts, lengths, family: str, *, threads: int = 256,
                       n_words: int | None = None, max_len: int | None = None):
    """The kernel's words and ok for each window, step by step.  Returns
    ``(words int32[B, W], ok bool[B], steps Counter, routes Counter)``:
    ``steps`` counts the Duval, scan, chain and merge steps, ``routes`` the
    blocks that were staged and those that read device memory."""
    flat = np.asarray(flat, np.uint8)
    starts, lengths = np.asarray(starts, np.int64), np.asarray(lengths, np.int32)
    base, threshold, comb = FAMILY_PLANS[family]
    kbase, threshold = BASES[base], threshold or 0
    B, N = len(starts), len(flat)
    if max_len is None:
        max_len = max(int(lengths.max()), 0) if B else 0
    if n_words is None:
        n_words = max(1, -(-max_len // 32))
    if kbase != BASES["cfl"] and max_len > MAX_ICFL_WIDTH:
        raise ValueError("ICFL plans take rows of up to 1023 characters")
    regs = max_len <= REG_WIDTH and n_words <= 4
    st_dtype = np.uint8 if (regs or kbase == BASES["cfl"] or max_len <= 255) else np.uint16
    lmax = max_len if kbase != BASES["cfl"] else 0
    strip_words = 4 if regs else min(n_words, STRIP_WORDS)
    cand_words = 0 if regs or kbase == BASES["cfl"] else n_words
    cap = span_cap(threads, max_len)

    words = np.zeros((B, n_words), np.uint32)
    ok = np.zeros(B, bool)
    steps, routes = Counter(), Counter()
    for b0 in range(0, B, threads):
        block = range(b0, min(B, b0 + threads))
        valid = {}
        for b in block:
            start, n = int(starts[b]), int(lengths[b])
            valid[b] = (start >= 0 and n >= 0 and start <= N - n and n <= 32 * n_words
                        and (kbase == BASES["cfl"] or n <= lmax))
        spans = [(int(starts[b]), int(starts[b]) + int(lengths[b])) for b in block if valid[b]]
        lo = min((s for s, _ in spans), default=np.iinfo(np.int64).max)
        hi = max((e for _, e in spans), default=-1)
        staged = stage(flat, lo, hi, cap)
        routes["staged" if staged else "device"] += 1
        for b in block:
            if not valid[b]:
                continue
            start, n = int(starts[b]), int(lengths[b])
            if staged:
                smem, span0, staged_len = staged
                off = start - span0
                fwd, rcw = staged_text(smem, off), staged_text(smem, cap + staged_len - off - n)
            else:
                fwd, rcw = device_text(flat, start), device_rc_text(flat, start, n)
            st = np.zeros(max(lmax, 1), st_dtype)
            if regs:
                out, cand = RegBits(), RegBits()
                window_passes(kbase, fwd, rcw, n, threshold, comb, st, cand, out, steps)
                words[b] = out.w[:n_words]
                ok[b] = True
                continue
            cand = RowBits([0] * cand_words, 0, 32 * cand_words)
            for w0 in range(0, n_words, strip_words):
                out = RowBits([0] * strip_words, 32 * w0, 32 * (w0 + strip_words))
                window_passes(kbase, fwd, rcw, n, threshold, comb, st, cand, out, steps)
                width = min(strip_words, n_words - w0)
                words[b, w0 : w0 + width] = out.words[:width]
                assert not any(cand.words), "the merge clears every candidate it visits"
            ok[b] = True
    return words.view(np.int32), ok, steps, routes


# ---------------------------------------------------------------------- #
# inputs
# ---------------------------------------------------------------------- #

EDGE_LENGTHS = (0, 1, 31, 32, 33, 127, 128, 129, 255, 256, 1023)


def _row(rng, n: int, kind: int) -> str:
    if kind == 0:
        return ("AC" * n)[:n]
    if kind == 1:
        return "T" * max(n - 1, 0) + "A"[: n > 0]
    if kind == 2:
        return ("ACACGTGT" * (n // 8 + 1))[:n]
    alphabet = [b"ACGT", b"ACGTN", b"ACGTacgt?N\x01\xff"][kind % 3]
    lut = np.frombuffer(alphabet, np.uint8)
    return lut[rng.integers(0, len(lut), size=n)].tobytes().decode("latin-1")


def _rows(seed: int, lengths) -> list[str]:
    rng = np.random.default_rng(seed)
    return [_row(rng, n, k) for k, n in enumerate(lengths)]


def _stream_of(texts):
    """``window_stream(texts, shift=False)`` for texts with bytes above 127."""
    data = [t.encode("latin-1") for t in texts]
    starts = np.cumsum([0] + [len(d) for d in data[:-1]]).astype(np.int64)
    flat = np.frombuffer(b"".join(data), np.uint8).copy()
    return flat, starts, np.array([len(d) for d in data], np.int32)


def _shift_stream(seed: int, n_reads: int, read_len: int, alphabet: bytes):
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(alphabet, np.uint8)
    texts = [lut[rng.integers(0, len(lut), size=read_len)].tobytes().decode()
             for _ in range(n_reads)]
    texts.append(("AC" * read_len)[:read_len])
    flat, starts, lengths, _ = window_stream(texts, shift=True)
    return flat, starts, lengths


def _plain(flat, starts, lengths, family):
    words, ok = icfl_cuda.factor_words_plain(torch.from_numpy(flat), torch.from_numpy(starts),
                                             torch.from_numpy(lengths), family)
    return words.numpy(), ok.numpy()


def _assert_model_equals_plain(flat, starts, lengths, family, **kw):
    words, ok, steps, routes = factor_words_model(flat, starts, lengths, family, **kw)
    want_words, want_ok = _plain(flat, starts, lengths, family)
    assert np.array_equal(ok, want_ok), family
    W = want_words.shape[1]
    assert not words[:, W:].any(), family
    bad = np.flatnonzero((words[:, :W] != want_words).any(axis=1))
    assert not len(bad), f"{family}: rows {bad[:8]} differ from the plain version"
    return steps, routes


# ---------------------------------------------------------------------- #
# the steps, one by one
# ---------------------------------------------------------------------- #


def test_complement_map_is_the_scalar_models_for_every_byte():
    assert [complement(u) for u in range(256)] == COMPLEMENT
    x = int.from_bytes(b"ACG\x07", "little")
    assert complement_reversed(x).to_bytes(4, "little") == b"NCGT"


@pytest.mark.parametrize("lo,hi", [(0, 100), (3, 357), (17, 17), (1000, 1460), (5, 2000)])
def test_staged_span_and_rc_slices(lo, hi):
    rng = np.random.default_rng(lo + hi)
    flat = np.frombuffer(b"ACGTN\x00x", np.uint8)[rng.integers(0, 7, size=1470)]
    cap = span_cap(256, 100)
    got = stage(flat, lo, hi, cap)
    if align16(hi - (lo & ~15)) > cap:
        assert got is None
        return
    smem, span0, staged_len = got
    assert span0 % 16 == 0 and staged_len % 16 == 0 and span0 <= lo and span0 + staged_len >= hi
    for start in range(lo, hi + 1, 7):
        for n in {0, 1, hi - start, min(100, hi - start)}:
            off = start - span0
            fwd = [staged_text(smem, off)[x] for x in range(n)]
            rcw = [staged_text(smem, cap + staged_len - off - n)[x] for x in range(n)]
            window = flat[start : start + n].tolist()
            assert fwd == window
            assert rcw == [COMPLEMENT[c] for c in window[::-1]]
            assert rcw == [device_rc_text(flat, start, n)[x] for x in range(n)]


def test_reg_bits_select_and_highest_match_python_ints():
    rng = np.random.default_rng(3)
    bits, ref = RegBits(), 0
    for p in rng.integers(0, 128, size=300):
        p = int(p)
        if rng.random() < 0.3:
            bits.clear(p)
            ref &= ~(1 << p)
        else:
            bits.set(p)
            ref |= 1 << p
        assert sum(w << (32 * k) for k, w in enumerate(bits.w)) == ref
        assert bits.highest(128, 0) == ref.bit_length() - 1
    row = RowBits([0] * 4, 64, 192)
    for p in (0, 63, 64, 100, 191, 192, 500):
        row.set(p)
    assert row.words == [1, 1 << 4, 0, 1 << 31]  # only [64, 192) is this strip's
    # the merge clears each bit it visits, so the highest left is the next lower one
    assert row.highest(192, 64) == 191
    row.clear(191)
    assert row.highest(191, 64) == 100
    row.clear(100)
    assert row.highest(100, 96) == -1 and row.highest(100, 64) == 64


def _icfl_levels(s: bytes):
    """The level records of the old kernel (one array entry a level) and its
    fold: what the state-minimal layout must reproduce."""
    base, rem, levels = 0, len(s), []
    st = [0] * len(s)
    while True:
        i, j, c = 0, 1, 0
        while j < rem:
            si, sj = s[base + i], s[base + j]
            st[j] = i
            if sj > si:
                c = sj
                break
            i = i + 1 if sj == si else 0
            j += 1
        if j >= rem:
            break
        best, b = i, i
        while b > 0:
            b = st[b]
            if s[base + b] < c:
                best = b
        plen = j - best
        levels.append((base + plen, best))
        base += plen
        rem -= plen
    cuts, cur = set(), rem
    for m in range(len(levels) - 1, -1, -1):
        pos, last = levels[m]
        plen = pos - (levels[m - 1][0] if m else 0)
        if cur > last:
            cuts.add(pos)
            cur = plen
        else:
            cur += plen
    return levels, cuts


@pytest.mark.parametrize("text", ["AC" * 40, "T" * 255 + "A", "ACACGTGT" * 12, "CCGCGCCGCGA",
                                  "GTACGTTAGCCATG" * 5, "A", "CA"])
def test_parked_last_and_candidate_merge_match_level_records(text):
    s = text.encode()
    n = len(s)
    levels, cuts = _icfl_levels(s)
    st = np.zeros(n, np.uint8)
    cand, out = (RegBits(), RegBits()) if n <= REG_WIDTH else (
        RowBits([0] * 8, 0, 256), RowBits([0] * 8, 0, 256))
    steps = Counter()
    icfl_segment(Text(lambda x: s[x]), n, 0, n, st, cand, out, False, steps)
    # each level's bound sits at its old base, the previous candidate
    prev = ([0] + [pos for pos, _ in levels])[: len(levels)]
    assert [int(st[p]) for p in prev] == [last for _, last in levels]
    got = {p for p in range(n) if (out.words if isinstance(out, RowBits) else out.w)[p >> 5]
           >> (p & 31) & 1}
    assert got == cuts
    assert steps["merge"] == len(levels)


@pytest.mark.parametrize("text", ["AC" * 40, "T" * 127 + "A", "ACACGTGT" * 12, "GTACGTTAGCCATG" * 5])
def test_icfl_loop_forms_agree(text):
    """The one-loop and the nested scan of ``icfl_segment`` leave the same
    ``st[]``, candidates and marks, with the same steps."""
    s, n = text.encode(), len(text)
    got = []
    for flat in (True, False):
        st, cand, out, steps = np.zeros(n, np.uint8), RegBits(), RegBits(), Counter()
        icfl_segment(Text(lambda x: s[x]), n, 0, n, st, cand, out, False, steps, flat)
        got.append((st.tolist(), cand.w, out.w, steps))
    assert got[0] == got[1]


def test_segments_fold_apart_in_cfl_icfl():
    """Two long Duval factors back to back: each segment's merge sees only
    its own candidates, and the shared candidate row ends empty."""
    text = ("AC" * 20 + "ACC") + ("AAC" * 15 + "AC")
    flat, starts, lengths = _stream_of([text])
    for family in ("CFL_ICFL-10", "CFL_ICFL_COMB-10"):
        for kw in ({}, {"n_words": 8}):  # registers, then a shared row
            _assert_model_equals_plain(flat, starts, lengths, family, **kw)


# ---------------------------------------------------------------------- #
# the whole kernel against the plain versions
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("family", FAMILIES)
def test_model_matches_plain_on_edge_widths(family):
    """Rows of every edge width (periodic, homopolymer-ended, N-bearing and
    non-ACGT rows), in blocks of 32 so that several blocks meet."""
    texts = _rows(7, [n for n in EDGE_LENGTHS for _ in range(3)])
    _assert_model_equals_plain(*_stream_of(texts), family, threads=32)


@pytest.mark.parametrize("family", FAMILIES)
def test_model_matches_plain_on_shift_windows_both_routes(family):
    """Shift windows (staged), the same windows shuffled, overlapping and
    decreasing (device memory), and windows at the stream's end and outside it."""
    flat, starts, lengths = _shift_stream(11, 2, 128, b"ACGTN")
    steps, routes = _assert_model_equals_plain(flat, starts, lengths, family, threads=64)
    assert routes["staged"] >= 5
    rng = np.random.default_rng(12)
    order = rng.permutation(len(starts))[:64]
    mixed_starts = np.concatenate([starts[order], starts[::-1][:40],
                                   [len(flat) - 100, len(flat) - 7, len(flat), len(flat) - 3, -1]])
    mixed_lengths = np.concatenate([lengths[order], lengths[::-1][:40],
                                    np.array([100, 7, 0, 100, 5], np.int32)])
    _, routes = _assert_model_equals_plain(flat, mixed_starts.astype(np.int64), mixed_lengths,
                                           family, threads=32)
    assert routes["device"] >= 2 and routes["staged"] >= 1


@pytest.mark.parametrize("family", ["CFL_COMB", "ICFL_COMB", "CFL_ICFL_COMB-20"])
def test_model_matches_plain_on_300_character_chunks(family):
    """The generalized mode's chunks: consecutive rows of 300, unstaged."""
    rng = np.random.default_rng(300)
    texts = [_row(rng, 300, 3 + k % 3) for k in range(6)] + [_row(rng, 300, 2)]
    steps, routes = _assert_model_equals_plain(*_stream_of(texts), family, threads=32)
    assert routes == Counter(device=1)


def test_model_marks_wide_duval_rows_a_strip_at_a_time():
    """A Duval-only row wider than one strip of 128 words: both passes run
    again for each strip, and every strip is written once."""
    texts = _rows(21, [4097, 5])
    _assert_model_equals_plain(*_stream_of(texts), "CFL_COMB", threads=32)


def test_model_flags_rows_the_kernel_refuses():
    """``n > 32 W``, windows outside the stream and ICFL rows wider than the
    call's ``max_len``: zero words and ok 0."""
    flat, starts, lengths = _stream_of(["ACGTTGCA" * 12, "CAT", "GATTACA"])
    for family in ("CFL_COMB", "ICFL_COMB"):
        words, ok, _, _ = factor_words_model(flat, starts, lengths, family, n_words=2)
        assert ok.tolist() == [False, True, True] and not words[0].any()
        want, _ = _plain(flat, starts[1:], lengths[1:], family)
        assert np.array_equal(words[1:, :1], want)
    words, ok, _, _ = factor_words_model(flat, starts, lengths, "ICFL", max_len=50)
    assert ok.tolist() == [False, True, True]
    bad = np.array([len(flat) - 2, -4, 3], np.int64)
    words, ok, _, _ = factor_words_model(flat, bad, np.array([3, 2, -1], np.int32), "CFL")
    assert not ok.any() and not words.any()


# ---------------------------------------------------------------------- #
# against the JAX package's Pallas kernels
# ---------------------------------------------------------------------- #


def _jax_family_masks(texts: list[str]) -> dict[str, np.ndarray]:
    """Each family's start mask composed from the Pallas kernels in interpret
    mode: ``cfl_boundaries_pallas`` for Duval starts and ``icfl_words_fused``
    for ICFL, over the rows, their reverse complements and the long Duval
    factors of both, as ``fpmash_tpu/ops/factorize.py`` composes them."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.icfl_pallas import icfl_words_fused
    from fpmash_tpu.ops.lyndon import encode_batch
    from fpmash_tpu.ops.lyndon_pallas import cfl_boundaries_pallas

    rcs = ["".join(chr(COMPLEMENT[ord(ch)]) for ch in t[::-1]) for t in texts]
    strands = texts + rcs
    arr, lens = encode_batch(strands)
    cfl = np.asarray(cfl_boundaries_pallas(jnp.asarray(arr), jnp.asarray(lens),
                                           interpret=True)) > 0

    def factors(mask_row, n):
        pos = [int(p) for p in np.flatnonzero(mask_row[:n])]
        return list(zip(pos, [b - a for a, b in zip(pos, pos[1:] + [n])]))

    # every string the ICFL kernel must see: whole strands, and their long factors
    icfl_strings = {s for s in strands}
    for s, row in zip(strands, cfl):
        for a, p in factors(row, len(s)):
            if p > 10:
                icfl_strings.add(s[a : a + p])
    icfl_strings = sorted(icfl_strings)
    arr, lens = encode_batch(icfl_strings)
    words, jok = icfl_words_fused(jnp.asarray(arr), jnp.asarray(lens), pack="byte4",
                                  interpret=True)
    assert np.asarray(jok).all()
    words = np.asarray(words).astype(np.uint64)
    icfl = {s: [p for p in range(len(s)) if int(words[r, p >> 5]) >> (p & 31) & 1]
            for r, s in enumerate(icfl_strings)}

    def base_starts(k, base, threshold):
        s, n = strands[k], len(strands[k])
        if base == "icfl":
            return set(icfl[s]) | ({0} if n else set())
        out = {a for a, _ in factors(cfl[k], n)}
        if base == "cfl_icfl":
            for a, p in factors(cfl[k], n):
                if p > threshold:
                    out |= {a + c for c in icfl[s[a : a + p]]}
        return out

    masks = {}
    for family, (base, threshold, comb) in FAMILY_PLANS.items():
        L = max(len(t) for t in texts)
        mask = np.zeros((len(texts), L), bool)
        for k, t in enumerate(texts):
            n = len(t)
            cuts = base_starts(k, base, threshold)
            if comb:
                rc_thr = RC_THRESHOLD if base == "cfl_icfl" else threshold
                cuts |= {n - c for c in base_starts(len(texts) + k, base, rc_thr) if 1 <= c}
            mask[k, sorted(cuts)] = True
        masks[family] = mask
    return masks


def test_model_matches_pallas_kernels_in_interpret_mode_for_all_families():
    rng = np.random.default_rng(41)
    texts = [_row(rng, int(n), k % 5) for k, n in enumerate(rng.integers(1, 45, size=14))]
    texts = [t for t in texts if t] + ["AC" * 22, "T" * 43 + "A", "ACACGTGT" * 5, "A", "CA"]
    flat, starts, lengths = _stream_of(texts)
    masks = _jax_family_masks(texts)
    for family in FAMILIES:
        words, ok, _, _ = factor_words_model(flat, starts, lengths, family, threads=32)
        assert ok.all()
        bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little").astype(bool)
        want = masks[family]
        assert np.array_equal(bits[:, : want.shape[1]], want), family
        assert not bits[:, want.shape[1] :].any()
