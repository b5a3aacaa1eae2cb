"""Port: a model of the steps of ``csrc/winnow.cu`` (the minmer selection) vs
the references.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- the wrapper's
launch plan (``ops/winnow.launch_plan``: tiles of ``R`` starts, more than
the window for windows of a few positions, their span ``[s0, s0 + R - 1 +
ws)`` staged or read in place, the block's threads, starts a thread,
candidates in shared memory or a scratch region);
each block's pass over the span (every position's range start ``f``, the
core's and the span's distinct counts, the core's least and greatest first
occurrence), the block that marks every candidate at once (``mins < 1``, or
a span of fewer than ``mins`` values), the bound ``T`` from one histogram of
``_BINS`` bins over ``[lo, hi]`` and its refinement while the candidates
overflow their room, the gather in a shuffled order (the atomics), the sort
by (hash, index) (by rank up to a block of candidates, a bitonic network
past it), and the sweep (each warp streams the sorted candidates 32 at a
time and ballots them: a range over all the warp's starts adds to the
warp's count, one over some of them to its threads' counts in registers)
-- is held exactly (positions and hashes) against
the JAX package's ``minmer_positions`` on its numpy route and its XLA jit
on the CPU, the port's plain version and the reference's incremental model
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
BIN_BITS = 11  # log2(winnow._BINS)
WARP = 32
PAD = 0xFFFFFFFF  # kPad: the index of a bitonic pad, after every candidate
CPU = torch.device("cpu")
_MIX = np.uint64(0x9E3779B97F4A7C15)


def stage(h, prev, s0: int, R: int, ws: int):
    """The block's pass over its span: hashes and range starts ``f`` (the
    first start of the tile whose window has ``p`` as the first occurrence
    of ``h[p]``, relative to ``s0``, clamped to ``[0, R]``: ``f < R`` marks a
    candidate), and the masks of candidates and of the core ``[R - 1, ws)``."""
    span = R + ws - 1
    hs = h[s0 : s0 + span]
    fs = np.clip(prev[s0 : s0 + span] + 1 - s0, 0, R)
    i = np.arange(span)
    return hs, fs, fs < R, (i >= R - 1) & (i < ws)


def pick_bin(chist, shist, k: int, threads: int):
    """The block's pick: thread ``t`` owns bins ``[t per, (t + 1) per)``
    (core and span counts packed in one word), an exclusive scan over the
    threads, and the thread whose core counts reach ``k`` walks its bins.
    ``(bin, span entries up to it)``."""
    per = len(chist) // threads
    csum = chist.reshape(threads, per).sum(1)
    ssum = shist.reshape(threads, per).sum(1)
    cex = np.concatenate([[0], np.cumsum(csum)[:-1]])
    sex = np.concatenate([[0], np.cumsum(ssum)[:-1]])
    hit = np.flatnonzero((cex < k) & (cex + csum >= k))
    assert len(hit) == 1, "the k-th core entry lies in one thread's bins"
    t = int(hit[0])
    c, s = int(cex[t]), int(sex[t])
    for b in range(t * per, (t + 1) * per):
        c += int(chist[b])
        s += int(shist[b])
        if c >= k:
            return b, s
    raise AssertionError("the thread's bins do not reach its scan")


def bound(hs, cand, core, mins: int, cap: int, threads: int, stats: Counter):
    """``T' >= T`` (the ``mins``-th smallest distinct value of the core) and
    the candidates at or below it: a histogram of the core's and the span's
    candidates in ``_BINS`` bins of ``2^shift`` values from ``base`` (first
    ``[lo, hi]`` of the core), ``T'`` the upper edge of the bin holding the
    core's ``mins``-th; again inside that bin while the candidates overflow
    ``cap`` and the bins are wider than one value."""
    v = hs[cand]
    in_core = core[cand]
    lo, hi = int(v[in_core].min()), int(v[in_core].max())
    base, shift = lo, max((hi - lo).bit_length() - BIN_BITS, 0)
    while True:
        stats["bound_passes"] += 1
        below = v < np.uint64(base)
        k = mins - int((below & in_core).sum())
        assert k >= 1
        d = (v[~below] - np.uint64(base)) >> np.uint64(shift)
        inb = d < winnow._BINS
        shist = np.bincount(d[inb].astype(np.int64), minlength=winnow._BINS)
        chist = np.bincount(d[inb & in_core[~below]].astype(np.int64), minlength=winnow._BINS)
        b, upto = pick_bin(chist, shist, k, threads)
        edge = base + (b << shift)
        t = min(edge + (1 << shift) - 1, U64MAX)
        nc = int(below.sum()) + upto
        if nc <= cap or shift == 0:
            return t, nc
        stats["refinements"] += 1
        base, shift = edge, max(shift - BIN_BITS, 0)


def _less(ka, ia, kb, ib):
    return (ka < kb) | ((ka == kb) & (ia < ib))


def rank_sort(hs, idx):
    """Up to a block of candidates: thread ``r`` counts the candidates below
    its own by (hash, gather slot) and writes it at that rank (equal hashes
    keep their gather order: their ranges are disjoint, so any order does)."""
    k = hs[idx]
    slot = np.arange(len(idx))
    rank = _less(k[None, :], slot[None, :], k[:, None], slot[:, None]).sum(1)
    out = np.empty_like(idx)
    out[rank] = idx
    return out


def bitonic_sort(hs, idx, p2: int):
    """Past a block of candidates: the bitonic network over ``p2`` entries,
    pads (key 2^64 - 1, index ``PAD``) after every candidate; a stage's
    compare-exchanges at once."""
    ix = np.concatenate([idx, np.full(p2 - len(idx), PAD, np.int64)])
    key = np.where(ix == PAD, np.uint64(U64MAX), hs[np.minimum(ix, len(hs) - 1)])
    i = np.arange(p2 // 2)
    k = 2
    while k <= p2:
        j = k >> 1
        while j > 0:
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo | j
            up = (lo & k) == 0
            swap = np.where(up, _less(key[hi], ix[hi], key[lo], ix[lo]),
                            _less(key[lo], ix[lo], key[hi], ix[hi]))
            a, b = lo[swap], hi[swap]
            key[a], key[b] = key[b], key[a].copy()
            ix[a], ix[b] = ix[b], ix[a].copy()
            j >>= 1
        k <<= 1
    assert (ix[len(idx):] == PAD).all()
    return ix[: len(idx)]


def sweep(order, fs, R: int, ws: int, threads: int, K: int, mins: int, stats: Counter):
    """The flags of the sorted candidates ``order``.  Thread ``t`` counts, in
    registers, the candidates so far whose range holds each of its starts
    ``[t K, t K + K)``, past those that covered all the warp's starts, which
    only add to the warp's ``g``; ``wmin`` is the warp's least count.  Each
    warp streams the candidates 32 at a time (a lane loads one and its range
    ``[a, b]``) and ballots them.  One that covers all the warp's starts is
    flagged while ``g`` (as it comes) plus ``wmin`` is below ``mins``; one
    that covers some is taken in order: a thread flags it where a start of
    its range has counted fewer than ``mins``, then counts it there.  The
    warp stops once every start has counted ``mins``."""
    nc = len(order)
    a_all = np.maximum(fs[order], order - (ws - 1))
    b_all = np.minimum(order, R - 1)
    assert (a_all <= b_all).all(), "every candidate's range meets the tile"
    flag = np.zeros(nc, bool)
    lane_starts = np.arange(WARP)[:, None] * K + np.arange(K)[None, :]
    none = 1 << 31  # kNone: a start past the tile
    for w in range(threads // WARP):
        wb = w * WARP * K
        if wb >= R:
            break
        we = min(wb + WARP * K, R)
        s = wb + lane_starts
        used = np.where(s < R, 0, none)
        g = wmin = 0
        for c0 in range(0, nc, WARP):
            if g + wmin >= mins:
                stats["warp_early_exits"] += 1
                break
            stats["sweep_chunks"] += 1
            a, b = a_all[c0 : c0 + WARP], b_all[c0 : c0 + WARP]
            hit = (a < we) & (b >= wb)
            full = hit & (a <= wb) & (b >= we - 1)
            at_wmin = np.full(len(a), wmin)
            for j in np.flatnonzero(hit & ~full):
                gj = g + int(full[:j].sum())
                cover = (s >= a[j]) & (s <= b[j])
                flag[c0 + j] |= bool((cover & (gj + used < mins)).any())
                used = used + cover
                wmin = int(used.min())
                at_wmin[j + 1 :] = wmin
                stats["sweep_steps"] += 1
            for j in np.flatnonzero(full):
                flag[c0 + j] |= g + int(full[:j].sum()) + int(at_wmin[j]) < mins
                stats["full_covers"] += 1
            g += int(full.sum())
    return flag


def smem(plan) -> int:
    """The block's dynamic shared memory, as the kernel's entry point
    counts it: the histograms and counters, the staged span, the
    candidates."""
    return (winnow._FIXED_BYTES + winnow._STAGE_BYTES * plan.span * plan.stage
            + winnow._CANDIDATE_BYTES * plan.cap)


def block(h, prev, n: int, ws: int, mins: int, plan, s0: int, marks, rng, stats: Counter,
          loosen=None):
    """One block of ``winnow_kernel``: the tile of starts from ``s0``."""
    s1 = min(s0 + plan.tile, n - ws + 1)
    R = s1 - s0
    hs, fs, cand, core = stage(h, prev, s0, R, ws)
    assert s0 + len(hs) <= n, "the span lies in h"
    assert core.any() == (R <= ws), "a tile of more starts than the window has no core"
    stats["coreless_tiles"] += R > ws
    span_values = int((fs == 0).sum())  # prev[p] < s0: first in the span
    core_values = int((cand & core).sum())
    if mins < 1 or span_values < mins:
        # every window of the tile has fewer than mins values (or T is 0):
        # every candidate at or below T is marked, with no sort or sweep
        t = 0 if mins < 1 else U64MAX
        marks[s0 + np.flatnonzero(cand & (hs <= np.uint64(t)))] = True
        stats["all_marked_tiles"] += 1
        return
    if core_values < mins:
        t, nc = U64MAX, int(cand.sum())
        stats["T=max"] += 1
    else:
        t, nc = bound(hs, cand, core, mins, plan.cap, plan.threads, stats)
    if loosen is not None:
        t2 = loosen(t)
        assert t2 >= t
        t, nc = t2, int((cand & (hs <= np.uint64(t2))).sum())
    order = np.flatnonzero(cand & (hs <= np.uint64(t)))
    assert len(order) == nc
    room = plan.cap
    if nc > plan.cap:  # the block's device-memory region
        stats["overflow_tiles"] += 1
        room = plan.scratch_cap
    order = rng.permutation(order)  # the atomics' order
    p2 = 1 << max(nc - 1, 0).bit_length()
    assert loosen is not None or p2 <= room, "the candidates overflow their room"
    if nc <= plan.threads:
        stats["rank_sorted"] += 1
        order = rank_sort(hs, order)
    else:
        stats["bitonic_sorted"] += 1
        order = bitonic_sort(hs, order, p2)
    assert (np.diff(hs[order].astype(object)) >= 0).all()
    stats["candidates"] += nc
    flag = sweep(order, fs, R, ws, plan.threads, plan.starts, mins, stats)
    marks[s0 + order[flag]] = True


def kernel_model(hashes, window_size: int, mins: int, seed: int = 0, stats=None, loosen=None):
    """``minmer_positions`` on a card, as the model runs it: ``(positions,
    hashes)`` pairs."""
    stats = Counter() if stats is None else stats
    h = np.ascontiguousarray(hashes, np.uint64)
    n = len(h)
    if n == 0:
        return []
    ws = min(window_size, n)
    prev = winnow.prev_occurrence(torch.from_numpy(h.view(np.int64).copy())).numpy()
    plan = winnow.launch_plan(n, ws)
    assert plan.per >= 1 and smem(plan) <= winnow._SMEM_MAX
    assert plan.tile <= plan.starts * plan.threads and plan.threads % WARP == 0
    need = 1 << (plan.span - 1).bit_length()
    assert plan.cap & (plan.cap - 1) == 0 and (plan.scratch_cap == 0) == (plan.cap >= need)
    assert plan.scratch_cap in (0, need)
    assert winnow._BINS % plan.threads == 0
    mins = min(max(mins, 0), 2**31 - 1)
    marks = np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    for t0 in range(0, plan.n_tiles, plan.per):
        stats["launches"] += 1
        for b in range(t0, min(t0 + plan.per, plan.n_tiles)):
            block(h, prev, n, ws, mins, plan, b * plan.tile, marks, rng, stats, loosen)
    stats["tiles"] += plan.n_tiles
    return [(int(p), int(h[p])) for p in np.flatnonzero(marks)]


def _hashes(rng, n: int, kind: str) -> np.ndarray:
    """u64 hashes of ``kind``: ``full`` uniform over 2^64, ``repeats`` 9
    values spread over the range, ``few`` 3 values, ``edges`` only 0, 5,
    2^63 and 2^64 - 1, ``narrow`` uniform below 2^32 (k <= 16)."""
    if kind == "full":
        return rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2) + \
            rng.integers(0, 2, size=n, dtype=np.uint64)
    if kind == "edges":
        vals = np.array([0, 5, 1 << 63, U64MAX], np.uint64)
        return vals[rng.integers(0, 4, size=n)]
    if kind == "narrow":
        return rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
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
    """Tiles of at most 4 starts (no floor of blocks), 32 threads a block,
    8 candidates in shared memory, launches of at most 3 tiles: every
    branch of the kernel on inputs of a few hundred."""
    monkeypatch.setattr(winnow, "TILE_MAX", 4)
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    monkeypatch.setattr(winnow, "THREADS_MIN", 32)
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
    assert stats["launches"] > 70 and stats["coreless_tiles"] > 0
    # few values keep a tile's candidates near its starts plus the values,
    # and most spans below mins values: the overflow path is held below
    assert (stats["overflow_tiles"] > 0) == (kind in ("full", "repeats"))
    assert stats["all_marked_tiles"] > 0 and stats["sweep_steps"] > 0


# ws around the tile (4 starts here) and around twice it, past n; mins 0,
# 1, 5 and more than the values; each also on tiles of one start
@pytest.mark.parametrize("ws", [1, 2, 3, 4, 5, 7, 8, 9, 10, 33, 200])
@pytest.mark.parametrize("mins", [0, 1, 5, 40])
def test_model_matches_references_at_the_edges(ws, mins, small_geometry, monkeypatch):
    rng = np.random.default_rng(ws * 100 + mins)
    for kind in ("full", "repeats", "few", "edges"):
        h = _hashes(rng, 97, kind)  # 97 - ws + 1 starts: ragged tiles
        want = _references(h, ws, mins)
        assert kernel_model(h, ws, mins, seed=ws) == want, kind
        with monkeypatch.context() as m:
            m.setattr(winnow, "TILE_MAX", 1)
            assert kernel_model(h, ws, mins, seed=ws) == want, (kind, "one start a tile")


def test_model_at_the_kernels_geometry():
    """The wrapper's own constants: tiles of ws // 2 starts or fewer (a
    block an SM), candidates in shared memory; a window of 8 200 (tiles of 7
    starts), and 32-bit hashes (the bins follow ``[lo, hi]``)."""
    rng = np.random.default_rng(7)
    stats = Counter()
    for n, ws, mins, kind in ((300, 40, 5, "full"), (300, 64, 70, "repeats"),
                              (120, 300, 3, "few"), (3000, 200, 10, "narrow"),
                              (9000, 8200, 4, "full")):
        h = _hashes(rng, n, kind)
        assert kernel_model(h, ws, mins, stats=stats) == _references(h, ws, mins)
    assert winnow.launch_plan(9000, 8200).tile == 7
    assert stats["overflow_tiles"] == stats["refinements"] == 0
    assert stats["bound_passes"] > 0 and stats["rank_sorted"] > 0


def test_model_tile_at_tile_max_and_starts_a_thread(monkeypatch):
    """Full tiles of ``TILE_MAX`` starts with no floor of blocks: 2 and 4
    starts a thread in the sweep, the bitonic network past a block of
    candidates, warps leaving the sweep early."""
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    rng = np.random.default_rng(17)
    seen = set()
    for n, ws, mins, kind, tmin in ((3000, 1400, 40, "full", 128), (900, 300, 20, "full", 32),
                                    (700, 300, 250, "full", 32)):
        monkeypatch.setattr(winnow, "THREADS_MIN", tmin)
        plan = winnow.launch_plan(n, ws)
        seen.add(plan.starts)
        h = _hashes(rng, n, kind)
        stats = Counter()
        assert kernel_model(h, ws, mins, stats=stats) == _references(h, ws, mins)
        assert stats["warp_early_exits"] > 0 or stats["bitonic_sorted"] > 0
    assert seen == {2, 4}


def test_model_low_complexity_threshold_is_max(small_geometry):
    """A run of 3 values: every span has fewer than ``mins`` values, so
    every window's threshold is 2^64 - 1 and the block marks each of its
    candidates at once, with no bound, sort or sweep."""
    rng = np.random.default_rng(8)
    h = _hashes(rng, 110, "few")
    stats = Counter()
    got = kernel_model(h, 30, 5, stats=stats)
    assert got == _references(h, 30, 5)
    assert stats["all_marked_tiles"] == stats["tiles"] > 0
    assert stats["sweep_steps"] == stats["bound_passes"] == 0


def test_model_core_below_mins_values(small_geometry):
    """A core of fewer than ``mins`` values in a span of more: ``T`` is
    2^64 - 1, every candidate is swept."""
    rng = np.random.default_rng(18)
    h = np.concatenate([_hashes(rng, 40, "few"), _hashes(rng, 60, "full")])
    stats = Counter()
    assert kernel_model(h, 30, 6, stats=stats) == _references(h, 30, 6)
    assert stats["T=max"] > 0 and stats["sweep_steps"] > 0


def test_model_overflow_path_alone(monkeypatch):
    """Every swept tile past shared memory (a cap of 1), scratch regions of
    the launch's blocks, and a scratch budget of one tile a launch; with 3
    values every span is below mins values, so no tile keeps candidates."""
    monkeypatch.setattr(winnow, "TILE_MAX", 6)
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    monkeypatch.setattr(winnow, "SHARED_CAP", 1)
    monkeypatch.setattr(winnow, "SCRATCH_BYTES", 1)
    rng = np.random.default_rng(9)
    for kind in ("full", "repeats", "few"):
        h = _hashes(rng, 150, kind)
        stats = Counter()
        got = kernel_model(h, 25, 6, stats=stats)
        assert got == _references(h, 25, 6)
        path = "all_marked_tiles" if kind == "few" else "overflow_tiles"
        assert stats[path] == stats["tiles"] == stats["launches"]
    plan = winnow.launch_plan(150, 25)
    assert (plan.tile, plan.n_tiles, plan.per, plan.cap, plan.scratch_cap) == (6, 21, 1, 1, 32)


def test_model_refines_a_crowded_bin(monkeypatch):
    """Hashes clustered in one bin of ``[lo, hi]`` (an outlier stretches the
    range): the first pass's bin holds more candidates than shared memory,
    so the bound is refined inside it until they fit."""
    monkeypatch.setattr(winnow, "SHARED_CAP", 256)
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    rng = np.random.default_rng(19)
    h = rng.integers(0, 1 << 20, size=3000, dtype=np.uint64)
    h[::500] = np.uint64(U64MAX - 7)
    stats = Counter()
    assert kernel_model(h, 800, 30, stats=stats) == _references(h, 800, 30)
    assert stats["refinements"] > 0 and stats["overflow_tiles"] == 0


def test_launch_plan_bounds_scratch():
    """find's defaults (-L 10 000, mins 100): the chromosome, one chunk of
    1 677 starts, a query strand of 4 980 positions (one window), 1 000 000
    positions; the plasmid at -k 16 (-L 1 000); a window of 3 (tiles of
    ``THREADS_MIN`` starts): all staged, none with scratch; a window of
    50 000 past the stage and the candidates' room."""
    P = winnow.Plan
    assert winnow.launch_plan(4_999_980, 10_000) == P(3072, 13071, 1625, 1625, 1024, 4, 16384,
                                                     True, 0)
    assert winnow.launch_plan(11_676, 10_000) == P(13, 10012, 129, 129, 1024, 1, 16384, True, 0)
    assert winnow.launch_plan(4980, 4980) == P(1, 4980, 1, 1, 1024, 1, 8192, True, 0)
    assert winnow.launch_plan(1_000_000, 10_000).n_tiles == 323
    assert winnow.launch_plan(199_985, 1000) == P(500, 1499, 398, 398, 256, 2, 2048, True, 0)
    assert winnow.launch_plan(30_000, 3) == P(128, 130, 235, 235, 128, 1, 256, True, 0)
    big = winnow.launch_plan(300_000, 50_000)
    assert not big.stage and big.scratch_cap == 65536 and big.cap == 32768
    assert big.per * big.scratch_cap * 5 <= winnow.SCRATCH_BYTES
    for plan in (winnow.launch_plan(4_999_980, 10_000), big):
        assert smem(plan) <= winnow._SMEM_MAX


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


@pytest.mark.parametrize("kind", ["full", "repeats", "few", "edges"])
def test_range_identity(kind):
    """Each distinct value of ``W(s)`` has exactly one candidate of the tile
    whose range ``[max(f, i - ws + 1), min(i, R - 1)]`` holds ``s``: its
    first occurrence there.  So counting the candidates below ``h[p]`` whose
    range holds ``s`` counts the distinct values of ``W(s)`` below it."""
    rng = np.random.default_rng(30)
    for _ in range(20):
        n = int(rng.integers(20, 150))
        h = _hashes(rng, n, kind)
        ws = int(rng.integers(2, n // 2))
        prev = winnow.prev_occurrence(torch.from_numpy(h.view(np.int64).copy())).numpy()
        num_w = n - ws + 1
        R = int(rng.integers(1, ws // 2 + 1))
        for s0 in range(0, num_w, R):
            r = min(R, num_w - s0)
            hs, fs, cand, _ = stage(h, prev, s0, r, ws)
            i = np.arange(len(hs))
            a, b = np.maximum(fs, i - (ws - 1)), np.minimum(i, r - 1)
            for s in range(r):
                holds = cand & (a <= s) & (s <= b)
                window = h[s0 + s : s0 + s + ws]
                assert sorted(hs[holds].tolist()) == sorted(set(window.tolist()))
                assert (i[holds] + s0 == [s0 + s + window.tolist().index(v)
                                          for v in hs[holds].tolist()]).all()


@pytest.mark.parametrize("loose", ["max", "next bin"])
def test_looser_bound_gives_the_same_marks(loose, small_geometry):
    """A bound ``T' >= T`` admits more candidates but the sweep counts
    exactly, so the marks are the same."""
    rng = np.random.default_rng(31)
    fn = (lambda t: U64MAX) if loose == "max" else (lambda t: min(t + (1 << 60), U64MAX))
    for kind in ("full", "repeats", "edges"):
        for ws, mins in ((20, 3), (41, 7), (9, 2)):
            h = _hashes(rng, 130, kind)
            assert kernel_model(h, ws, mins, loosen=fn) == _references(h, ws, mins)


def test_mins_zero_marks_only_planted_zero_hashes(small_geometry, monkeypatch):
    """``mins < 1``: the threshold is 0, so only a hash equal to 0 can be
    marked, at its first occurrence in some window."""
    rng = np.random.default_rng(32)
    h = _hashes(rng, 200, "full")
    h[[3, 50, 51, 120, 199]] = 0
    for tile_max in (winnow.TILE_MAX, 1):  # tiles of more starts than a window of 2
        monkeypatch.setattr(winnow, "TILE_MAX", tile_max)
        for ws in (2, 30, 200):
            got = kernel_model(h, ws, 0)
            assert got == _references(h, ws, 0) and got
            assert {x for _, x in got} == {0}
    assert kernel_model(h, 30, -5) == kernel_model(h, 30, 0)


@pytest.mark.parametrize("ws", [1, 2, 3])
def test_small_windows_take_tiles_of_many_starts(ws, monkeypatch):
    """Windows of 1-3 positions: tiles of ``THREADS_MIN`` starts, a start a
    thread, fewer where that keeps ``MIN_BLOCKS`` blocks; each tile's core
    is empty (``T`` = 2^64 - 1), so every first occurrence of its span is a
    candidate and the sweep counts them exactly."""
    rng = np.random.default_rng(33 + ws)
    plan = winnow.launch_plan(50_000, ws)
    assert plan.tile == plan.threads == winnow.THREADS_MIN and plan.starts == 1
    assert plan.n_tiles == -(-(50_000 - ws + 1) // winnow.THREADS_MIN)
    assert winnow.launch_plan(5000, ws).tile == -(-(5000 - ws + 1) // winnow.MIN_BLOCKS)
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    for kind in ("full", "repeats", "few", "edges"):
        h = _hashes(rng, 700, kind)
        for mins in (0, 1, 2, 5):
            stats = Counter()
            assert kernel_model(h, ws, mins, stats=stats) == _references(h, ws, mins)
            assert stats["coreless_tiles"] == stats["tiles"] == 6
            assert stats["bound_passes"] == 0


def test_single_tile_query_shape():
    """A find query strand: 4 980 positions, the window clamped to them (one
    start, one tile, one block), mins 100."""
    rng = np.random.default_rng(34)
    h = _hashes(rng, 4980, "full")
    stats = Counter()
    got = kernel_model(h, 10_000, 100, stats=stats)
    assert got == _references(h, 10_000, 100) and len(got) == 100
    assert stats["tiles"] == stats["launches"] == 1 and stats["rank_sorted"] == 1
    assert stats["sweep_chunks"] <= 4  # one thread's counts reach 0 by then


def test_sorts_agree():
    """The rank sort and the bitonic network order the same candidates by
    hash; the network breaks ties by index, the rank sort by gather slot."""
    rng = np.random.default_rng(35)
    for kind in ("full", "repeats", "edges"):
        hs = _hashes(rng, 300, kind)
        idx = rng.permutation(300)[:170]
        assert bitonic_sort(hs, idx, 256).tolist() == sorted(idx.tolist(),
                                                             key=lambda i: (int(hs[i]), i))
        slot = {int(i): r for r, i in enumerate(idx)}
        assert rank_sort(hs, idx).tolist() == sorted(idx.tolist(),
                                                     key=lambda i: (int(hs[i]), slot[i]))
