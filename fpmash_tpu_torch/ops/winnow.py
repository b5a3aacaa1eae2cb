"""Windowed min-hash ("minmer") selection: its kernel, plain version and wrapper.

Counterpart of :mod:`fpmash_tpu.ops.winnow` (the reference's
``getMinHashPositions``, Sketch.cpp:737-1047), whose device route is an XLA
jit (``_make_chunk_jit``, ``fpmash_tpu/ops/winnow.py:105``), not a Pallas
kernel.  The declarative formulation, held against the reference's
incremental model (``scalar/winnow.py``) by the tests:

    position ``p`` is a minmer  iff  some full window ``W`` of
    ``window_size`` consecutive k-mer positions contains ``p`` such that
      * ``h[p]`` is among the bottom ``mins`` *distinct* hash values of
        ``W`` (all values qualify if ``W`` has fewer than ``mins``
        distinct), and
      * ``p`` is the earliest occurrence of ``h[p]`` within ``W``.

:func:`minmer_marks` launches the CUDA kernel (``csrc/winnow.cu``) for
tensors on a CUDA device: tiles of window starts (:func:`launch_plan`), a
block each; no ``[C, ws]`` window is gathered.  For tensors on the CPU it
runs the plain version, :func:`minmer_marks_plain`: window starts in chunks
of ``CHUNK_ELEMS[device.type] // ws`` rows (:func:`chunk_marks`), the ``[C,
ws]`` windows, each row sorted, the row's ``mins``-th distinct value as its
threshold, every entry at or below it whose previous occurrence lies before
the window's start marked, and the marks OR-ed into position space.
``LAUNCHES`` counts the kernel's launches.  :func:`prev_occurrence` stays
in PyTorch on either device: its counterpart in the JAX package is a host
``np.argsort``, not a device op.

Hashes are ``int64`` tensors holding the u64 bits.  The order that counts is
the unsigned one: the kernel compares them as u64; the plain version sorts
and compares *keys*, the hashes with their sign bit flipped, whose signed
order is the hashes' unsigned order.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from fpmash_tpu_torch.device import to_device, to_host

#: the plain version's window elements ``[C, ws]`` per chunk: 16 Mi on a
#: card; 1 Mi on the CPU, the JAX package's numpy chunk (tests shrink it to
#: cross chunk edges)
CHUNK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 20}

#: kernel launches in this process (the plain version does not count), and
#: the same launches by ``(n, ws, mins)`` (``ws`` as launched: clamped to n)
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()
#: the kernel's geometry (``csrc/winnow.cu``): a tile of at most
#: ``TILE_MAX`` starts a block, fewer where that keeps ``MIN_BLOCKS`` blocks
#: (one an SM); ``THREADS_MIN`` to ``THREADS_MAX`` threads a block; at most
#: ``SHARED_CAP`` candidates in shared memory (a power of two; tests shrink
#: it).  A block whose candidates may exceed its room uses its region of
#: device-memory scratch, in launches of at most ``LAUNCH_TILES`` tiles and
#: ``SCRATCH_BYTES``.
TILE_MAX, MIN_BLOCKS = 3072, 132
THREADS_MIN, THREADS_MAX = 128, 1024
SHARED_CAP, LAUNCH_TILES, SCRATCH_BYTES = 1 << 16, 1024, 1 << 28
#: a copy of the kernel's shared-memory layout (kBins, kMiscBytes and
#: kSmemMax in ``csrc/winnow.cu``, whose entry point rejects a plan that does
#: not fit): histogram bins, the bytes a block may take, the fixed bytes (two
#: histograms, the block's counters), a staged position (hash, range start),
#: a candidate (its index into the span, flag); and the candidates a staged
#: span leaves room for at least
_BINS, _SMEM_MAX = 2048, 232_448
_FIXED_BYTES, _STAGE_BYTES, _CANDIDATE_BYTES = _BINS * 8 + 512, 8 + 2, 4 + 1
_STAGE_ROOM = 1024


class Plan(NamedTuple):
    """The kernel's geometry over ``n`` positions and window ``ws``
    (:func:`launch_plan`)."""

    tile: int  # window starts a block
    span: int  # positions a block reads: ws + tile - 1
    n_tiles: int
    per: int  # tiles a launch
    threads: int  # threads a block
    starts: int  # starts a thread in the sweep: 1, 2 or 4
    cap: int  # candidates in shared memory (a power of two)
    stage: bool  # the tile's span staged in shared memory
    scratch_cap: int  # device-memory candidates a block (0: none allocated)


_SIGN = -(1 << 63)
#: the key of 2^64 - 1, the threshold of a row with fewer than ``mins`` values
_KEY_MAX = (1 << 63) - 1


def prev_occurrence(h: torch.Tensor) -> torch.Tensor:
    """``prev[p]`` = the largest ``q < p`` with ``h[q] == h[p]``, else -1.

    A stable sort puts equal hashes in position order; any total order of
    the values does, since only equality counts.
    """
    n = h.numel()
    prev = torch.full((n,), -1, dtype=torch.int64, device=h.device)
    if n > 1:
        _, order = torch.sort(h, stable=True)
        same = h[order[1:]] == h[order[:-1]]
        prev[order[1:][same]] = order[:-1][same]
    return prev


def chunk_marks(keys: torch.Tensor, prev: torch.Tensor, w0: int, c: int, ws: int,
                mins: int) -> torch.Tensor:
    """Positions (``int64``, with repeats) marked by window starts ``w0 ..
    w0 + c - 1``: ``keys`` the sign-flipped hashes, ``prev`` their previous
    occurrences (:func:`prev_occurrence`)."""
    win = keys.unfold(0, ws, 1)[w0 : w0 + c]  # [c, ws] view, gathered by the sort
    srt = torch.sort(win, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = first.cumsum(1, dtype=torch.int32)
    if mins < 1:
        # no entry has rank mins: the threshold is 0, as in the JAX package
        t = torch.full((c,), _SIGN, dtype=torch.int64, device=keys.device)
    else:
        # ranks rise by at most one an entry, so the first entry of rank
        # mins (a first occurrence) follows the entries of lower rank
        at = (rank < mins).sum(1)
        t = srt.gather(1, at.clamp(max=ws - 1)[:, None])[:, 0]
        t = torch.where(at < ws, t, _KEY_MAX)
    starts = torch.arange(w0, w0 + c, device=keys.device)
    qual = (win <= t[:, None]) & (prev.unfold(0, ws, 1)[w0 : w0 + c] < starts[:, None])
    row, col = qual.nonzero(as_tuple=True)
    return starts[row] + col


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def launch_plan(n: int, ws: int) -> Plan:
    """The kernel's :class:`Plan` over ``n`` positions and window ``ws``.

    A tile holds half a window of starts (at most ``TILE_MAX``, and fewer
    where that keeps ``MIN_BLOCKS`` blocks), so that the core all its windows
    share (``ws - tile + 1`` positions) bounds their thresholds tightly.  A
    window of under ``2 THREADS_MIN`` positions takes a tile of
    ``THREADS_MIN`` starts, a start a thread: its core is small or empty, so
    it admits more candidates, from far fewer blocks.  The span (``ws + tile
    - 1`` positions) is staged in shared memory where it fits beside
    ``_STAGE_ROOM`` candidates; the candidates take the rest, up to
    the span rounded up to a power of two (the most a tile can have), and
    device-memory scratch of that size a block only where they do not fit.
    A block takes an eighth of that power of two in threads, so that a
    thread sweeps 1, 2 or 4 starts."""
    num_w = n - ws + 1
    tile = max(1, min(max(ws // 2, THREADS_MIN), TILE_MAX, -(-num_w // MIN_BLOCKS)))
    n_tiles = -(-num_w // tile)
    span = ws + tile - 1
    need = _pow2_ceil(span)
    threads = min(THREADS_MAX, max(THREADS_MIN, need // 8))
    starts = next(k for k in (1, 2, 4) if tile <= k * threads)
    stage = _FIXED_BYTES + _STAGE_BYTES * span + _CANDIDATE_BYTES * _STAGE_ROOM <= _SMEM_MAX
    room = (_SMEM_MAX - _FIXED_BYTES - _STAGE_BYTES * span * stage) // _CANDIDATE_BYTES
    cap = min(SHARED_CAP, need, 1 << (room.bit_length() - 1))
    if cap == need:
        return Plan(tile, span, n_tiles, n_tiles, threads, starts, cap, stage, 0)
    per = max(1, min(n_tiles, LAUNCH_TILES, SCRATCH_BYTES // (_CANDIDATE_BYTES * need)))
    return Plan(tile, span, n_tiles, per, threads, starts, cap, stage, need)


def minmer_marks(h: torch.Tensor, prev: torch.Tensor, ws: int, mins: int) -> torch.Tensor:
    """``uint8 [n]`` marks of the minmer positions of hashes ``h`` (``int64``
    holding u64 bits) with their previous occurrences ``prev``
    (:func:`prev_occurrence`), window ``1 <= ws <= n``: the kernel on a CUDA
    device, :func:`minmer_marks_plain` on the CPU."""
    global LAUNCHES
    n = h.numel()
    for name, x in (("h", h), ("prev", prev)):
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int64 [n], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if prev.shape != h.shape or prev.device != h.device:
        raise ValueError(f"prev {tuple(prev.shape)} on {prev.device} does not match "
                         f"h {tuple(h.shape)} on {h.device}")
    if not 1 <= ws <= n:
        raise ValueError(f"window {ws} outside [1, {n}]")
    dev = h.device
    if dev.type == "cpu":
        return minmer_marks_plain(h, prev, ws, mins).to(torch.uint8)
    if dev.type != "cuda":
        raise ValueError(f"minmer_marks runs on cpu or cuda tensors, not {dev}")
    from fpmash_tpu_torch.ops._build import check, library

    plan = launch_plan(n, ws)
    marks = torch.zeros(n, dtype=torch.uint8, device=dev)
    scratch = [None, None]
    if plan.scratch_cap:
        scratch = [torch.empty(plan.per * plan.scratch_cap, dtype=dt, device=dev)
                   for dt in (torch.int32, torch.uint8)]
    mins = min(max(mins, 0), 2**31 - 1)  # any mins < 1, or above ws, selects alike
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t0 in range(0, plan.n_tiles, plan.per):
            code = library().fpmash_winnow(
                h.data_ptr(), prev.data_ptr(), n, ws, mins, plan.tile, t0,
                min(plan.per, plan.n_tiles - t0), plan.threads, plan.starts, plan.cap,
                int(plan.stage), *(None if x is None else x.data_ptr() for x in scratch),
                plan.scratch_cap, marks.data_ptr(), stream)
            check(code, "winnow kernel launch")
            LAUNCHES += 1
            LAUNCH_SHAPES[(n, ws, mins)] += 1
    return marks


def minmer_marks_plain(h: torch.Tensor, prev: torch.Tensor, ws: int, mins: int) -> torch.Tensor:
    """Plain version of :func:`minmer_marks`, on any device: ``bool [n]``,
    the windows of :func:`chunk_marks` in chunks of ``CHUNK_ELEMS`` elements."""
    n = h.numel()
    num_w = n - ws + 1
    C = max(1, min(num_w, CHUNK_ELEMS[h.device.type] // ws))
    keys = h ^ _SIGN
    mark = torch.zeros(n, dtype=torch.bool, device=h.device)
    for w0 in range(0, num_w, C):
        mark[chunk_marks(keys, prev, w0, min(C, num_w - w0), ws, mins)] = True
    return mark


def minmer_positions(hashes, window_size: int, mins: int, *, device):
    """Minmer ``(positions u32, hashes u64)`` numpy arrays of per-position
    ``hashes`` (u64 values, numpy or ``int64`` tensor), in ascending
    position order like the reference's ``getMinHashPositions``.

    The window is clamped to the number of positions (Sketch.cpp:748-751).
    The selection runs on ``device`` (:func:`minmer_marks`); only the
    minmers leave it.
    """
    device = torch.device(device)
    if isinstance(hashes, torch.Tensor):
        h = hashes.to(device=device, dtype=torch.int64).contiguous()
    else:
        h = to_device(np.array(hashes, np.uint64), device)
    n = h.numel()
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint64)
    ws = min(window_size, n)
    if ws < 1:
        raise ValueError(f"window_size must be at least 1, got {window_size}")
    pos = minmer_marks(h, prev_occurrence(h), ws, mins).nonzero().flatten()
    return to_host(pos).astype(np.uint32), to_host(h[pos]).view(np.uint64)
