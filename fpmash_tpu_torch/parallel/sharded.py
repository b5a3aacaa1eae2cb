"""Sharded routes: row shards, the bottom-k merge, all-pairs tiles.

Counterpart of :mod:`fpmash_tpu.parallel.sharded`, with its names and
contracts.  The JAX package runs ``shard_map`` over a 1-D ``dp`` mesh from
one controller; here one process runs every shard.  A mesh is a tuple of
``torch.device`` (``device.resolve_devices``; a device may repeat, so
several shards may share one card or the CPU); shard ``i`` takes the ``i``-th
contiguous block of ``ceil(B / D)`` rows and runs on ``mesh[i]``, on that
device's current stream (each kernel wrapper enters ``torch.cuda.device`` of
its tensors and launches on ``torch.cuda.current_stream``).  Every shard is
dispatched before any result is read; then the results are gathered in
shard order on ``mesh[0]``: the JAX package's ``all_gather`` becomes a copy
to the first device.

A shard left without rows (fewer rows than shards) does not run, and the
last block may be short, so no pad row is ever made: the JAX package pads
``B`` to a multiple of ``D`` because ``shard_map`` needs equal shards.  The
kernels are row-independent, so every result is bit for bit that of one
device.  With one shard each function is exactly the single-device call.

Hashes are ``int64`` tensors holding u64 bits (``ops/murmur3.py``); numpy
``uint64`` arrays are taken as their ``int64`` view.  Unsigned order, where
a function needs it, comes from the sign-flipped sorts of ``ops/bottomk.py``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from fpmash_tpu_torch.device import to_device
from fpmash_tpu_torch.ops import bottomk, compare, compare_cuda, fused_cuda, walk_cuda


def row_blocks(n: int, shards: int) -> list[tuple[int, int]]:
    """Row ranges ``[b0, b1)`` of the shards that get rows: ``ceil(n /
    shards)`` rows each, the last one possibly fewer."""
    size = -(-n // shards)
    return [(b0, min(b0 + size, n)) for b0 in range(0, n, size)] if n else []


def _gather(outs, dst: torch.device, dim: int):
    """Per-shard outputs (a tensor or a tuple of them) concatenated along
    ``dim`` in shard order on ``dst``."""
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(dst) for o in outs], dim=dim)
    return tuple(torch.cat([o[i].to(dst) for o in outs], dim=dim) for i in range(len(outs[0])))


def _run_shards(fn, arrays, mesh, out_dim: int):
    blocks = row_blocks(len(arrays[0]), len(mesh))
    if len(blocks) <= 1:
        return fn(*(to_device(a, mesh[0]) for a in arrays))
    outs = [fn(*(to_device(a[b0:b1], dev) for a in arrays))
            for (b0, b1), dev in zip(blocks, mesh)]
    return _gather(outs, mesh[0], out_dim)


def shard_rows(fn, arrays, mesh):
    """``fn(*arrays)`` data-parallel over ``mesh``, every input and output
    sharded along its leading (row) axis.

    The inputs share their leading dimension ``B``; shard ``i`` runs ``fn``
    on its block of rows on ``mesh[i]``, and the outputs (a tensor or a tuple
    of tensors) come back concatenated in shard order on ``mesh[0]``.  With
    one shard, or at most one row, this is ``fn(*arrays)`` on ``mesh[0]``.
    """
    return _run_shards(fn, arrays, mesh, 0)


def shard_windows(fn, flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray, mesh):
    """:func:`shard_rows` for windows ``flat[starts[b] : starts[b] +
    lengths[b]]`` of one host byte stream (the layout of
    ``ops/fused_cuda.py``): ``fn(flat, starts, lengths, device)`` returns
    tensors on ``device``, and each shard gets only the span of the stream
    that its windows cover, with its starts rebased, never the whole stream.
    With one shard, ``fn`` gets the arrays as they are."""
    blocks = row_blocks(len(starts), len(mesh))
    if len(blocks) <= 1:
        return fn(flat, starts, lengths, mesh[0])
    outs = []
    for (b0, b1), dev in zip(blocks, mesh):
        st, ln = starts[b0:b1], lengths[b0:b1]
        lo, hi = int(st.min()), int((st + ln).max())
        if hi <= lo and len(flat):  # only empty windows: keep a byte of the stream
            lo = min(lo, len(flat) - 1)
            hi = lo + 1
        outs.append(fn(flat[lo:hi], st - lo, ln, dev))
    return _gather(outs, mesh[0], 0)


def _replicas(arrays):
    """``dev -> arrays on dev``, each device's copy made once."""
    cache = {}

    def on(dev):
        if dev not in cache:
            cache[dev] = tuple(to_device(a, dev) for a in arrays)
        return cache[dev]

    return on


def sharded_fingerprint_hashes(mesh, windows, lengths, seed: int = 42) -> torch.Tensor:
    """``u8 [B, L]`` windows and their lengths -> ``int64 [B]`` hashes (h1 of
    MurmurHash3_x64_128 over each window's Duval factor lengths), kernel K1
    on each shard's rows (``ops/fused_cuda.fingerprint_hashes_fused``)."""
    return shard_rows(lambda w, n: fused_cuda.fingerprint_hashes_fused(w, n, seed)[0],
                      (windows, lengths), mesh)


def _local_bottom_k(hashes, valid, s: int) -> torch.Tensor:
    """Bottom-s distinct live hashes, ascending as unsigned, padded with
    ``-1`` (2^64 - 1, the pad: a real hash equal to it is dropped)."""
    return bottomk.bottom_k_distinct(hashes, valid, s=s)[0]


def sharded_bottom_k(mesh, hashes, valid, s: int) -> torch.Tensor:
    """Global bottom-s distinct hashes of a sharded pool: ``int64 [s]`` on
    ``mesh[0]``, padded with 2^64 - 1.

    Per-shard bottom-s -> the ``D s`` candidates gathered -> the same
    selection over them.  Correct because each of the global bottom-s
    distinct values is in the bottom-s of every shard that holds it.
    """
    cand = shard_rows(partial(_local_bottom_k, s=s), (hashes, valid), mesh)
    return _local_bottom_k(cand, cand != -1, s)


def shard_queries(kernel, mesh, ref, ref_len, qry, qry_len, *args):
    """``kernel(ref, ref_len, qry block, qry_len block, *args)`` on every
    shard of the query axis, the references copied once to each device;
    the kernel's ``[R, Q_shard]`` outputs gathered along the query axis on
    ``mesh[0]`` (the layout of :func:`sharded_all_pairs`)."""
    refs = _replicas((ref, ref_len))
    return _run_shards(lambda q, ql: kernel(*refs(q.device), q, ql, *args), (qry, qry_len),
                       mesh, 1)


def sharded_all_pairs(mesh, ref, ref_len, qry, qry_len, sketch_size: int):
    """``(common, denom) int32 [R, Q]`` of the sorted comparison (kernel K9,
    ``ops/compare_cuda.py``) with the queries sharded and the references
    on every shard."""
    return shard_queries(compare_cuda.pairwise_common_denom, mesh, ref, ref_len, qry, qry_len,
                         sketch_size)


def sharded_all_pairs_walk(mesh, ref, ref_len, qry, qry_len, sketch_size: int,
                           max_steps: int | None = None):
    """The order-dependent walk (kernel K2, ``ops/walk_cuda.py``) in the
    layout of :func:`sharded_all_pairs`.  ``max_steps`` is the JAX
    package's bound on the walk's trip count; the kernel's loop ends on its
    own, so it is only checked: a bound below ``min(sketch_size, S1 + S2)``,
    which could cut a walk, raises."""
    worst = min(sketch_size, ref.shape[1] + qry.shape[1])
    if max_steps is not None and max_steps < worst:
        raise ValueError(f"max_steps={max_steps} would cut walks of up to {worst} steps")
    return shard_queries(walk_cuda.pairwise_walk, mesh, ref, ref_len, qry, qry_len, sketch_size)


def sharded_all_pairs_positional(mesh, hashes, lens):
    """All-pairs positional matches of one set (``triangle -fp``,
    CommandTriangle.cpp:265) with the row axis sharded: each shard compares
    its rows against the whole set.  ``(matches, n) int32 [N, N]``."""
    table = _replicas((hashes, lens))
    return shard_rows(lambda h, n: compare.pairwise_positional(h, n, *table(h.device)),
                      (hashes, lens), mesh)


def sharded_all_pairs_replicated(mesh, ref, ref_len, qry, qry_len, sketch_size: int):
    """All-pairs (K9) with the references sharded and the queries on every
    shard: the layout for a query side of one merged sketch."""
    qrys = _replicas((qry, qry_len))
    return shard_rows(
        lambda r, rl: compare_cuda.pairwise_common_denom(r, rl, *qrys(r.device), sketch_size),
        (ref, ref_len), mesh)


def pipeline_step(mesh, windows, lengths, ref, ref_len, *, seed: int = 42,
                  sketch_size: int = 8):
    """The whole step over the mesh: windows -> Duval -> MurmurHash3 (K1,
    sharded) -> global bottom-k (merged on ``mesh[0]``) -> the sketch as one
    query against the sharded reference batch (K9).  Returns
    ``(sketch int64 [s], common int32 [R, 1], denom int32 [R, 1])``."""
    hashes = sharded_fingerprint_hashes(mesh, windows, lengths, seed)
    valid = torch.ones(hashes.shape, dtype=torch.bool, device=hashes.device)
    sketch = sharded_bottom_k(mesh, hashes, valid, sketch_size)
    qry_len = (sketch != -1).sum(dtype=torch.int32)[None]
    common, denom = sharded_all_pairs_replicated(mesh, ref, ref_len, sketch[None, :], qry_len,
                                                 sketch_size)
    return sketch, common, denom
