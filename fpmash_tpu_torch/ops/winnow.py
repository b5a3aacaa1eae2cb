"""Windowed min-hash ("minmer") selection on a device, in plain PyTorch.

Counterpart of :mod:`fpmash_tpu.ops.winnow` (the reference's
``getMinHashPositions``, Sketch.cpp:737-1047), whose device route is an XLA
jit, not a Pallas kernel.  The declarative formulation, held against the
reference's incremental model (``scalar/winnow.py``) by the tests:

    position ``p`` is a minmer  iff  some full window ``W`` of
    ``window_size`` consecutive k-mer positions contains ``p`` such that
      * ``h[p]`` is among the bottom ``mins`` *distinct* hash values of
        ``W`` (all values qualify if ``W`` has fewer than ``mins``
        distinct), and
      * ``p`` is the earliest occurrence of ``h[p]`` within ``W``.

Window starts go in chunks of ``CHUNK_ELEMS[device.type] // ws`` rows
(:func:`chunk_marks`): the ``[C, ws]`` windows, each row sorted, the row's
``mins``-th distinct value as its threshold, every entry at or below it
whose previous occurrence lies before the window's start marked, and the
marks OR-ed into position space.

Hashes are ``int64`` tensors holding the u64 bits.  The order that counts is
the unsigned one, so the windows are sorted and compared as *keys*, the
hashes with their sign bit flipped, whose signed order is the hashes'
unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

#: window elements ``[C, ws]`` per chunk: 16 Mi on a card; 1 Mi on the CPU,
#: the JAX package's numpy chunk (tests shrink it to cross chunk edges)
CHUNK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 20}

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


def minmer_positions(hashes, window_size: int, mins: int, *, device):
    """Minmer ``(positions u32, hashes u64)`` numpy arrays of per-position
    ``hashes`` (u64 values, numpy or ``int64`` tensor), in ascending
    position order like the reference's ``getMinHashPositions``.

    The window is clamped to the number of positions (Sketch.cpp:748-751).
    Every chunk runs on ``device``; only the minmers leave it.
    """
    device = torch.device(device)
    if isinstance(hashes, torch.Tensor):
        h = hashes.to(device=device, dtype=torch.int64)
    else:
        h = torch.from_numpy(np.array(hashes, np.uint64).view(np.int64)).to(device)
    n = h.numel()
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint64)
    ws = min(window_size, n)
    if ws < 1:
        raise ValueError(f"window_size must be at least 1, got {window_size}")
    num_w = n - ws + 1
    C = max(1, min(num_w, CHUNK_ELEMS[device.type] // ws))
    keys = h ^ _SIGN
    prev = prev_occurrence(h)
    mark = torch.zeros(n, dtype=torch.bool, device=device)
    for w0 in range(0, num_w, C):
        mark[chunk_marks(keys, prev, w0, min(C, num_w - w0), ws, mins)] = True
    pos = mark.nonzero().flatten()
    return (pos.cpu().numpy().astype(np.uint32),
            h[pos].cpu().numpy().view(np.uint64))
