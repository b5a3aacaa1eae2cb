"""Port: a model of the steps of ``csrc/winnow.cu`` (the minmer selection) vs
the references.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- the wrapper's
launch plan (``ops/winnow.launch_plan``: tiles of ``R`` starts, launches of
at most ``LAUNCH_TILES`` tiles, the scratch region a block), each block's
core ``[s1 - 1, s0 + ws)`` and its threshold ``T`` by the radix select (8
passes of 8 bits, the warp's choice of a bin), the candidates of the span
``[s0, s1 - 1 + ws)`` gathered in any order (a shuffled order stands for
the atomics) into shared memory or, past ``SHARED_CAP``, into the block's
device-memory region, the bitonic network over ``(hash, position)``, and
one thread a start walking the distinct hashes with galloping searches --
is held exactly (positions and hashes) against the JAX package's
``minmer_positions`` on its numpy route and its XLA jit on the CPU, the
port's plain version and the reference's incremental model
(``scalar/winnow.py``).  JAX is imported inside the tests that use it only.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import winnow
from fpmash_tpu_torch.scalar.winnow import minmer_position_hashes

U64MAX = (1 << 64) - 1
BINS = 256  # kBins
PAD_POS = 0xFFFFFFFF  # kPadPos
CPU = torch.device("cpu")
_MIX = np.uint64(0x9E3779B97F4A7C15)


def pick_bin(hist: list[int], k: int):
    """``pick_bin``: lane ``l`` of warp 0 sums bins ``[8 l, 8 l + 8)``; the
    first lane whose inclusive sum reaches ``k`` walks its bins.  ``(bin,
    rank inside it)``, or ``None`` when the histogram holds fewer than ``k``."""
    per = BINS // 32
    sums = [sum(hist[lane * per:(lane + 1) * per]) for lane in range(32)]
    incl = np.cumsum(sums).tolist()
    hit = [lane for lane in range(32) if incl[lane] >= k]
    if not hit:
        return None
    lane = hit[0]
    cum = incl[lane] - sums[lane]
    for i in range(per):
        c = hist[lane * per + i]
        if cum + c >= k:
            return lane * per + i, k - cum
        cum += c
    raise AssertionError("the lane's bins do not reach its inclusive sum")


def core_threshold(h, prev, c0: int, c1: int, mins: int, stats: Counter) -> int:
    """``core_threshold``: the ``mins``-th smallest hash of the core's
    positions with ``prev[p] < c0``, or 2^64 - 1 when there are fewer."""
    prefix = mask = 0
    k = mins
    for shift in range(56, -1, -8):
        hist = [0] * BINS
        for p in range(c0, c1):
            stats["core_reads"] += 1
            if prev[p] < c0 and (h[p] & mask) == prefix:
                hist[(h[p] >> shift) & (BINS - 1)] += 1
        picked = pick_bin(hist, k)
        if picked is None:
            assert shift == 56, "the select lost its rank after the first pass"
            return U64MAX
        b, k = picked
        prefix |= b << shift
        mask |= (BINS - 1) << shift
    return prefix


def bitonic_sort(key: list, pos: list, p: int) -> None:
    """``bitonic_sort`` of ``[0, p)`` by ``(key, pos)``, in place."""
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            for i in range(p // 2):
                lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
                hi = lo | j
                a, b = (key[lo], pos[lo]), (key[hi], pos[hi])
                if (b < a) if (lo & k) == 0 else (a < b):
                    key[lo], key[hi] = key[hi], key[lo]
                    pos[lo], pos[hi] = pos[hi], pos[lo]
            j >>= 1
        k <<= 1


def gallop(key, pos, i: int, n: int, v: int, at: int, by_pos: bool, stats: Counter) -> int:
    """``gallop``: the first index in ``[i, n)`` whose ``(key, pos)`` is not
    below ``(v, at)`` (``by_pos``) or whose key is above ``v``."""
    def ok(x):
        stats["search_reads"] += 1
        return key[x] > v or (by_pos and key[x] == v and pos[x] >= at)

    if i >= n or ok(i):
        return i
    lo, hi, step = i, n, 1
    while step < n - lo:
        if ok(lo + step):
            hi = lo + step
            break
        lo += step
        step <<= 1
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid
    return hi


def block(h, prev, n: int, ws: int, mins: int, tile: int, s0: int, cap: int, scratch_cap: int,
          marks: list, rng, stats: Counter) -> None:
    """One block of ``winnow_kernel``: the tile of starts from ``s0``."""
    num_w = n - ws + 1
    s1 = min(s0 + tile, num_w)
    last = s1 - 1
    assert last < s0 + ws, "the core is empty"
    t = 0 if mins < 1 else core_threshold(h, prev, last, s0 + ws, mins, stats)
    stats["T=max"] += t == U64MAX
    span = range(s0, last + ws)
    assert last + ws <= n
    order = list(span)
    rng.shuffle(order)  # the atomics' order
    cand = [(h[p], p - s0) for p in order if prev[p] < last and h[p] <= t]
    nc = len(cand)
    room = cap
    if nc > cap:  # the block's device-memory region
        stats["overflow_tiles"] += 1
        assert scratch_cap >= len(span), "a tile's candidates overflow its scratch region"
        room = scratch_cap
    p2 = 1
    while p2 < nc:
        p2 <<= 1
    assert p2 <= room
    key = [k for k, _ in cand] + [U64MAX] * (p2 - nc)
    pos = [q for _, q in cand] + [PAD_POS] * (p2 - nc)
    flag = [0] * p2
    bitonic_sort(key, pos, p2)
    assert list(zip(key, pos)) == sorted(zip(key, pos))
    stats["candidates"] += nc
    limit = (1 << 32) - 1 if mins < 1 else mins
    for s in range(s0, s1):
        lo, hi = s - s0, s - s0 + ws
        counted = i = 0
        while i < nc and counted < limit:
            v = key[i]
            j = gallop(key, pos, i, nc, v, lo, True, stats)
            if j < nc and key[j] == v and pos[j] < hi:
                flag[j] = 1
                counted += 1
            i = gallop(key, pos, j, nc, v, 0, False, stats)
            stats["groups"] += 1
    for i in range(nc):
        if flag[i]:
            marks[s0 + pos[i]] = 1


def kernel_model(hashes, window_size: int, mins: int, seed: int = 0, stats=None):
    """``minmer_positions`` on a card, as the model runs it: ``(positions,
    hashes)`` pairs."""
    stats = Counter() if stats is None else stats
    h_np = np.ascontiguousarray(hashes, np.uint64)
    n = len(h_np)
    if n == 0:
        return []
    ws = min(window_size, n)
    prev = winnow.prev_occurrence(torch.from_numpy(h_np.view(np.int64).copy())).tolist()
    h = [int(x) for x in h_np]
    tile, n_tiles, per, scratch_cap = winnow.launch_plan(n, ws)
    assert per >= 1 and (scratch_cap == 0) == (ws + tile - 1 <= winnow.SHARED_CAP)
    if scratch_cap:
        assert per * scratch_cap * 13 <= max(winnow.SCRATCH_BYTES, 13 * scratch_cap)
    mins = min(max(mins, 0), 2**31 - 1)
    marks = [0] * n
    rng = np.random.default_rng(seed)
    for t0 in range(0, n_tiles, per):
        stats["launches"] += 1
        for b in range(min(per, n_tiles - t0)):
            block(h, prev, n, ws, mins, tile, (t0 + b) * tile, winnow.SHARED_CAP, scratch_cap,
                  marks, rng, stats)
    stats["tiles"] += n_tiles
    return [(p, h[p]) for p in range(n) if marks[p]]


def _hashes(rng, n: int, kind: str) -> np.ndarray:
    """u64 hashes of ``kind``: ``full`` uniform over 2^64, ``repeats`` 9
    values spread over the range, ``few`` 3 values, ``edges`` only 0, 5,
    2^63 and 2^64 - 1."""
    if kind == "full":
        return rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2) + \
            rng.integers(0, 2, size=n, dtype=np.uint64)
    if kind == "edges":
        vals = np.array([0, 5, 1 << 63, U64MAX], np.uint64)
        return vals[rng.integers(0, 4, size=n)]
    alpha = 9 if kind == "repeats" else 3
    return rng.integers(1, alpha + 1, size=n).astype(np.uint64) * _MIX


def _pairs(pos, ph):
    return list(zip(pos.tolist(), ph.tolist()))


def _references(h, ws: int, mins: int):
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    want = _pairs(*jax_minmers(h, ws, mins, backend="scalar"))
    assert _pairs(*winnow.minmer_positions(h, ws, mins, device=CPU)) == want
    if mins >= 1:
        assert minmer_position_hashes([int(x) for x in h], ws, mins) == want
    return want


@pytest.fixture
def small_geometry(monkeypatch):
    """Tiles of at most 4 starts, 8 candidates in shared memory, launches of
    at most 3 tiles: every branch of the kernel on inputs of a few hundred."""
    monkeypatch.setattr(winnow, "TILE_MAX", 4)
    monkeypatch.setattr(winnow, "SHARED_CAP", 8)
    monkeypatch.setattr(winnow, "LAUNCH_TILES", 3)


@pytest.mark.parametrize("kind", ["full", "repeats", "few", "edges"])
def test_model_matches_references_on_random_cases(kind, small_geometry):
    rng = np.random.default_rng({"full": 1, "repeats": 2, "few": 3, "edges": 4}[kind])
    stats = Counter()
    for case in range(70):
        n = int(rng.integers(1, 120))
        h = _hashes(rng, n, kind)
        ws = int(rng.integers(1, 60))
        mins = int(rng.integers(0, 12))
        assert kernel_model(h, ws, mins, seed=case, stats=stats) == _references(h, ws, mins)
    assert stats["launches"] > 70
    # few values keep a tile's candidates near its starts plus the values:
    # under the cap of 8 (the overflow path is held alone below)
    assert (stats["overflow_tiles"] > 0) == (kind in ("full", "repeats"))


# ws around the tile (4 starts here) and around twice it, past n; mins 0,
# 1, 5 and more than the values
@pytest.mark.parametrize("ws", [1, 2, 3, 4, 5, 7, 8, 9, 10, 33, 200])
@pytest.mark.parametrize("mins", [0, 1, 5, 40])
def test_model_matches_references_at_the_edges(ws, mins, small_geometry):
    rng = np.random.default_rng(ws * 100 + mins)
    for kind in ("full", "repeats", "few", "edges"):
        h = _hashes(rng, 97, kind)  # 97 - ws + 1 starts: ragged tiles
        got = kernel_model(h, ws, mins, seed=ws)
        assert got == _references(h, ws, mins), kind


def test_model_at_the_kernels_geometry():
    """The wrapper's own constants: tiles of ws // 2 starts, candidates in
    shared memory; and a window whose tile reaches ``TILE_MAX``."""
    rng = np.random.default_rng(7)
    stats = Counter()
    for n, ws, mins, kind in ((300, 40, 5, "full"), (300, 64, 70, "repeats"),
                              (120, 300, 3, "few"), (9000, 8200, 4, "full")):
        h = _hashes(rng, n, kind)
        assert kernel_model(h, ws, mins, stats=stats) == _references(h, ws, mins)
    assert winnow.launch_plan(9000, 8200)[0] == winnow.TILE_MAX
    assert stats["overflow_tiles"] == 0


def test_model_low_complexity_threshold_is_max(small_geometry):
    """A run of 3 values: every core has fewer than ``mins`` values, so ``T``
    is 2^64 - 1 and every position of the span before the last start is a
    candidate; the starts' work is bounded by the 3 values, not the repeats."""
    rng = np.random.default_rng(8)
    h = _hashes(rng, 110, "few")
    stats = Counter()
    got = kernel_model(h, 30, 5, stats=stats)
    assert got == _references(h, 30, 5)
    assert stats["T=max"] == stats["tiles"] > 0
    assert stats["groups"] <= 3 * (110 - 30 + 1)


def test_model_overflow_path_alone(monkeypatch):
    """Every tile past shared memory (a cap of 1), scratch regions of the
    launch's blocks, and a scratch budget of one tile a launch."""
    monkeypatch.setattr(winnow, "TILE_MAX", 6)
    monkeypatch.setattr(winnow, "SHARED_CAP", 1)
    monkeypatch.setattr(winnow, "SCRATCH_BYTES", 1)
    rng = np.random.default_rng(9)
    for kind in ("full", "few"):
        h = _hashes(rng, 150, kind)
        stats = Counter()
        got = kernel_model(h, 25, 6, stats=stats)
        assert got == _references(h, 25, 6)
        assert stats["overflow_tiles"] == stats["tiles"] == stats["launches"]
    assert winnow.launch_plan(150, 25) == (6, 21, 1, 32)


def test_launch_plan_bounds_scratch():
    tile, n_tiles, per, cap = winnow.launch_plan(5_000_000, 10_000)
    assert (tile, n_tiles) == (2048, -(-(5_000_000 - 10_000 + 1) // 2048))
    assert cap == 16384 and per * cap * 13 <= winnow.SCRATCH_BYTES
    assert winnow.launch_plan(4980, 4980) == (2048, 1, 1, 8192)
    assert winnow.launch_plan(1000, 100) == (50, 19, 19, 0)


@pytest.mark.parametrize("n,ws,mins", [(257, 31, 5), (200, 64, 70), (90, 200, 3), (150, 9, 0)])
def test_model_matches_jax_device_route(n, ws, mins, small_geometry):
    """The XLA jit of the JAX package on the CPU."""
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    rng = np.random.default_rng(n + ws)
    for kind in ("full", "few"):
        h = _hashes(rng, n, kind)
        assert kernel_model(h, ws, mins) == _pairs(*jax_minmers(h, ws, mins, backend="jax"))


def test_model_result_does_not_depend_on_gather_order(small_geometry):
    rng = np.random.default_rng(10)
    h = _hashes(rng, 100, "repeats")
    runs = {tuple(kernel_model(h, 20, 4, seed=s)) for s in range(5)}
    assert len(runs) == 1
