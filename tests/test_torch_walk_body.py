"""Port: a numpy model of the steps of ``csrc/walk.cu`` (K2) vs the plain version.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- the launch
geometry (a block per reference row and up to 256 queries, whole warps),
the reference row staged in shared memory by 16-byte chunks at aligned
addresses with 8-byte loads at its ends and read 8 bytes a step, the
device-memory route for rows wider than the stage, each lane's ring of its
query row's hashes in shared memory (16-byte asynchronous copies of 4
hashes at a time, each read no earlier than 2 rounds after it was issued;
a list that starts at the second half of a chunk copies its first hash
alone), the warp's rounds of 4 predicated steps and the post-loop fix-up
-- is held exactly
against ``ops/walk_cuda.pairwise_walk_plain`` and the JAX package's Pallas
walk in interpret mode, and checks that nothing outside a list's first
``len`` elements is read and that every 16-byte copy is aligned.  JAX is imported inside the test that uses it only.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import walk_cuda

THREADS, STAGE_WIDTH = 256, 6144  # kThreads, kStageWidth
HALF, DEPTH, RING = 4, 1, 16  # kHalf, kDepth, kRing
STRIDE = RING + 2  # kRingStride
U64MAX = (1 << 64) - 1


class Memory:
    """u64 values at a byte address; loads are checked and counted."""

    def __init__(self, values, addr: int, stats: Counter):
        self.values = [int(v) for v in np.asarray(values, np.uint64).reshape(-1)]
        self.addr, self.stats = addr, stats

    def load_chunk(self, base: int, length: int, c: int) -> tuple[int, int]:
        """``load_chunk`` on the list at element ``base``: elements ``c`` and
        ``c + 1`` of ``list[0, length)``, 0 outside it."""
        if c >= 0 and c + 1 < length:
            assert (self.addr + 8 * (base + c)) % 16 == 0, "a 16-byte load is not aligned"
            self.stats["vector_loads"] += 1
            return self.values[base + c], self.values[base + c + 1]
        out = []
        for e in (c, c + 1):
            if 0 <= e < length:
                self.stats["scalar_loads"] += 1
                out.append(self.values[base + e])
            else:
                out.append(0)
        return out[0], out[1]

    def first_chunk(self, base: int) -> int:
        return -(((self.addr + 8 * base) >> 3) & 1)


def fill(ring: list, mem: Memory, base: int, length: int, rot: int, c: int, ready: int,
         stats: Counter, start: int = 0) -> None:
    """``fill``: the hashes of ``list[0, length)`` in ``[c, c + HALF)``, ``c >=
    0`` at a chunk boundary, into the ring slots of their elements, each slot
    holding ``(hash, element, the first round that may read it)``: a 16-byte
    copy a chunk at aligned addresses, of the bytes below ``length`` only
    (element ``e`` in slot ``(e + rot) % RING``; the ring starts at hash
    ``start`` of shared memory)."""
    assert c >= 0
    for e in range(c, c + HALF, 2):
        slot = (e + rot) % RING
        nbytes = 16 if e + 1 < length else 8 if e < length else 0
        if nbytes:
            assert (mem.addr + 8 * (base + e)) % 16 == 0, "unaligned source"
            assert (start + slot) % 2 == 0, "unaligned ring slot"
            assert slot + nbytes // 8 <= RING, "a 16-byte copy wraps the ring"
            stats[f"copies_{nbytes}"] += 1
        for x in range(nbytes // 8):
            ring[slot + x] = (mem.values[base + e + x], e + x, ready)


def fill_first(ring: list, mem: Memory, base: int, length: int, phase: int, rot: int,
               stats: Counter, start: int = 0) -> int:
    """The first ``(DEPTH + 1) HALF`` hashes, waited for before the first round (a list
    that starts at the second half of a chunk copies its first hash alone);
    returns ``filled``."""
    if phase and length > 0:
        stats["copies_8"] += 1
        ring[rot] = (mem.values[base], 0, 0)
    filled = phase
    for _ in range(DEPTH + 1):
        fill(ring, mem, base, length, rot, filled, 0, stats, start)
        filled += HALF
    return filled


class Lane:
    """One lane's pair: its reference row (staged or in device memory), its
    query row's ring, and its walk state."""

    def __init__(self, ref, la: int, qmem: Memory, qbase: int, lb: int, s: int, stats: Counter,
                 start: int):
        self.ref, self.la, self.qmem, self.qbase, self.lb, self.s = ref, la, qmem, qbase, lb, s
        self.stats, self.start = stats, start
        self.rot = ((qmem.addr + 8 * qbase) >> 3) & 1  # the list's chunk phase
        phase = self.rot
        self.ring = [None] * RING
        self.filled = fill_first(self.ring, qmem, qbase, lb, phase, self.rot, stats, start)
        self.i = self.j = self.common = self.denom = 0
        self.live = s > 0 and la > 0 and lb > 0

    def step(self, rnd: int) -> None:
        if not self.live:
            return
        a = self.ref[self.i]
        value, element, ready = self.ring[(self.j + self.rot) % RING]
        assert element == self.j and ready <= rnd, "the ring slot is not this hash yet"
        adv_i, adv_j = a <= value, value <= a
        self.i, self.j = self.i + adv_i, self.j + adv_j
        self.common += adv_i and adv_j
        self.denom += 1
        self.live = self.denom < self.s and self.i < self.la and self.j < self.lb
        self.stats["steps"] += 1

    def end_round(self, rnd: int) -> None:
        """Copy the next HALF hashes when fewer than (DEPTH + 1) HALF lie
        ahead of j; they may be read from DEPTH + 1 rounds on (``wait_group
        DEPTH`` at the end of each round)."""
        if self.live and self.filled - self.j < (DEPTH + 1) * HALF:
            fill(self.ring, self.qmem, self.qbase, self.lb, self.rot, self.filled,
                 rnd + DEPTH + 1, self.stats, self.start)
            self.filled += HALF

    def result(self) -> tuple[int, int]:
        denom = self.denom
        if denom < self.s:
            denom = min(denom + (self.la - self.i) + (self.lb - self.j), self.s)
        return self.common, denom


def stage(mem: Memory, base: int, n: int, threads: int, stats: Counter) -> Memory:
    """``stage``: the row's ``n`` hashes copied into shared memory (16-byte
    aligned, address 0), a chunk a thread per pass."""
    smem = [None] * n
    first = mem.first_chunk(base)
    for t in range(threads):
        for c in range(first + 2 * t, n, 2 * threads):
            v0, v1 = mem.load_chunk(base, n, c)
            if c >= 0:
                smem[c] = v0
            if c + 1 < n:
                smem[c + 1] = v1
    assert all(v is not None for v in smem), "a staged element was not written"
    return Memory(np.array(smem, np.uint64), 0, stats)


def launch_geometry(n_qry: int) -> tuple[int, int]:
    """``(threads, q_tiles)`` of ``fpmash_walk``."""
    threads = THREADS if n_qry >= THREADS else (n_qry + 31) // 32 * 32
    return threads, (n_qry + threads - 1) // threads


def walk_model(ref, ref_len, qry, qry_len, s: int, *, ref_addr: int = 0, qry_addr: int = 0,
               stage_width: int = STAGE_WIDTH):
    """The kernel's ``(common, denom)`` ``int32 [R, Q]`` for u64 lists
    ``ref [R, S1]`` at byte address ``ref_addr`` and ``qry [Q, S2]`` at
    ``qry_addr``, and a Counter of its blocks, routes, loads and steps."""
    (R, S1), (Q, S2) = ref.shape, qry.shape
    stats = Counter()
    rmem, qmem = Memory(ref, ref_addr, stats), Memory(qry, qry_addr, stats)
    common = np.full((R, Q), -1, np.int64)
    denom = np.full((R, Q), -1, np.int64)
    threads, q_tiles = launch_geometry(Q)
    staged = S1 <= stage_width
    for blk in range(R * q_tiles):
        r = blk // q_tiles
        la = min(max(int(ref_len[r]), 0), S1)
        ref_row = (stage(rmem, r * S1, la, threads, stats).values if staged
                   else rmem.values[r * S1 : r * S1 + la])
        stats["staged" if staged else "device"] += 1
        for w in range(0, threads, 32):  # a warp's lanes share their rounds
            qs = [(blk - r * q_tiles) * threads + t for t in range(w, w + 32)]
            # the rings follow the staged row (rounded up to a chunk)
            row_hashes = (S1 + 1) // 2 * 2 if staged else 0
            lanes = [Lane(ref_row, la, qmem, q * S2 if q < Q else 0,
                          min(max(int(qry_len[q]), 0), S2) if q < Q else 0, s, stats,
                          row_hashes + STRIDE * t)
                     for t, q in zip(range(w, w + 32), qs)]
            rnd = 0
            while any(lane.live for lane in lanes):
                for _ in range(HALF):
                    for lane in lanes:
                        lane.step(rnd)
                for lane in lanes:
                    lane.end_round(rnd)
                rnd += 1
                stats["rounds"] += 1
            for q, lane in zip(qs, lanes):
                if q < Q:
                    assert common[r, q] == -1, "a pair is walked twice"
                    common[r, q], denom[r, q] = lane.result()
    assert (common >= 0).all(), "a pair is never walked"
    return common.astype(np.int32), denom.astype(np.int32), stats


def _plain(ref, ref_len, qry, qry_len, s):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    c, d = walk_cuda.pairwise_walk_plain(t(ref.view(np.int64)), t(ref_len),
                                         t(qry.view(np.int64)), t(qry_len), s)
    return c.numpy(), d.numpy()


def _case(name: str):
    """``(ref, ref_len, qry, qry_len, s)``: u64 lists for one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def lists(n, width, pool=40):
        return rng.integers(0, pool, size=(n, width)).astype(np.uint64)

    def lens(n, width):
        return rng.integers(0, width + 1, size=n).astype(np.int32)

    R, Q, S1, S2, s = 6, 7, 24, 24, 30
    if name == "q_wide":  # one reference, queries over two blocks
        R, Q, S1, S2 = 1, 300, 6, 5
    elif name == "r_wide":  # one query, many references
        R, Q, S1, S2 = 40, 1, 5, 6
    elif name == "s1_is_1":
        S1 = 1
    elif name == "narrow_qry":
        S2 = 3
    elif name == "long_lists":  # rings wrap, refilled round after round
        R, Q, S1, S2, s = 2, 40, 90, 91, 1000
    ref, qry = lists(R, S1), lists(Q, S2)
    ref_len, qry_len = lens(R, S1), lens(Q, S2)
    ref_len[0], qry_len[0] = S1, S2
    if name == "empty":
        ref_len[:2], qry_len[:2] = 0, 0
    elif name == "lengths_out_of_range":
        ref_len[:3] = [-5, S1 + 3, 2**31 - 1]
        qry_len[:3] = [S2 + 1, -(2**31), -1]
    elif name == "s_is_1":
        s = 1
    elif name == "s_past_la_plus_lb":
        s = S1 + S2 + 5
    elif name == "high_bits":  # unsigned order, and the pad value 2^64 - 1 kept
        ref |= np.uint64(1 << 63)
        qry[::2] |= np.uint64(1 << 63)
        ref[:, ::5] = np.uint64(U64MAX)
        qry[:, ::3] = np.uint64(U64MAX)
    elif name == "repeats":
        ref[:, :] = np.uint64(7)
        qry[::2, :] = np.uint64(7)
    elif name == "sorted":
        ref = np.sort(rng.choice(1000, size=(R, S1)).astype(np.uint64), axis=1)
        qry = np.sort(rng.choice(1000, size=(Q, S2)).astype(np.uint64), axis=1)
    return ref, ref_len, qry, qry_len, s


CASES = ["unsorted", "long_lists", "q_wide", "r_wide", "s1_is_1", "narrow_qry", "empty",
         "lengths_out_of_range", "s_is_1", "s_past_la_plus_lb", "high_bits", "repeats", "sorted"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ["staged", "device"])
def test_model_matches_plain(case, route):
    ref, ref_len, qry, qry_len, s = _case(case)
    width = STAGE_WIDTH if route == "staged" else ref.shape[1] - 1
    c, d, stats = walk_model(ref, ref_len, qry, qry_len, s, stage_width=width)
    pc, pd = _plain(ref, ref_len, qry, qry_len, s)
    assert np.array_equal(c, pc) and np.array_equal(d, pd)
    assert stats[route] == len(ref) * launch_geometry(len(qry))[1]


@pytest.mark.parametrize("ref_addr,qry_addr", [(0, 0), (8, 0), (0, 8), (8, 8)])
def test_model_matches_plain_at_every_chunk_alignment(ref_addr, qry_addr):
    """Rows of odd width start on both halves of a 16-byte chunk; lists that
    start on the second half read their first element alone."""
    ref, ref_len, qry, qry_len, s = _case("unsorted")
    ref, qry = ref[:, :23], qry[:, :21]
    ref_len, qry_len = np.minimum(ref_len, 23), np.minimum(qry_len, 21)
    want = _plain(ref, ref_len, qry, qry_len, s)
    for width in (STAGE_WIDTH, 0):
        c, d, stats = walk_model(ref, ref_len, qry, qry_len, s, ref_addr=ref_addr,
                                 qry_addr=qry_addr, stage_width=width)
        assert np.array_equal(c, want[0]) and np.array_equal(d, want[1])
        assert stats["copies_16"] > stats["copies_8"]


@pytest.mark.parametrize("addr", [0, 8])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 8, 33])
@pytest.mark.parametrize("threads", [32, 64])
def test_stage_copies_the_row(addr, n, threads):
    stats = Counter()
    row = np.arange(100, 100 + 40, dtype=np.uint64)
    smem = stage(Memory(row, addr, stats), 3, n, threads, stats)
    assert smem.values == [int(v) for v in row[3 : 3 + n]]
    # 16-byte loads for every chunk inside the row, 8-byte ones at its ends
    assert stats["scalar_loads"] <= 2 and 2 * stats["vector_loads"] + stats["scalar_loads"] == n


@pytest.mark.parametrize("addr", [0, 8])
@pytest.mark.parametrize("length", [0, 1, 2, 5, 12, 90])
@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_ring_serves_every_hash_in_time(addr, length, rate):
    """Whatever the lane's advances (up to one a step), the ring slot of
    element j holds it, copied at least DEPTH + 1 rounds back, while j < len; every
    element is copied once and none outside ``[0, len)``."""
    rng = np.random.default_rng(length + addr)
    stats = Counter()
    mem = Memory(rng.integers(0, 1 << 62, size=100).astype(np.uint64), addr, stats)
    phase = ((addr + 8 * 2) >> 3) & 1
    ring, j = [None] * RING, 0
    filled = fill_first(ring, mem, 2, length, phase, phase, stats)
    for rnd in range(80):
        for go in rng.random(HALF) < rate:
            if j < length:
                value, element, ready = ring[(j + phase) % RING]
                assert (value, element) == (mem.values[2 + j], j) and ready <= rnd
                j += bool(go)
        if j < length and filled - j < (DEPTH + 1) * HALF:
            fill(ring, mem, 2, length, phase, filled, rnd + DEPTH + 1, stats)
            filled += HALF
    assert j == length
    assert 2 * stats["copies_16"] + stats["copies_8"] == length


@pytest.mark.parametrize("n_qry,want", [(1, (32, 1)), (31, (32, 1)), (33, (64, 1)),
                                        (255, (256, 1)), (256, (256, 1)), (257, (256, 2)),
                                        (1000, (256, 4))])
def test_launch_geometry(n_qry, want):
    assert launch_geometry(n_qry) == want


@pytest.mark.parametrize("S,cap", [(40, 30), (31, 1000), (16, 16)])
def test_model_matches_pallas_interpret(S, cap):
    import jax.numpy as jnp

    from fpmash_tpu.ops.walk_pallas import pairwise_walk_pallas

    rng = np.random.default_rng(S + cap)
    ref = rng.integers(0, 50, size=(8, S)).astype(np.uint64)
    qry = rng.integers(0, 50, size=(8, S)).astype(np.uint64)
    ref[1] |= np.uint64(1 << 63)
    qry[2, ::4] = np.uint64(U64MAX)
    rl = rng.integers(0, S + 1, size=8).astype(np.int32)
    ql = rng.integers(0, S + 1, size=8).astype(np.int32)
    jc, jd = pairwise_walk_pallas(jnp.asarray(ref), jnp.asarray(rl), jnp.asarray(qry),
                                  jnp.asarray(ql), sketch_size=cap, interpret=True)
    for width in (STAGE_WIDTH, 0):
        c, d, _ = walk_model(ref, rl, qry, ql, cap, ref_addr=8, stage_width=width)
        assert np.array_equal(c, np.asarray(jc)) and np.array_equal(d, np.asarray(jd))
