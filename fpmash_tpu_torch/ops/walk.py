"""Host wrapper of the merge-join walk: hash lists in, ``(common, denom)`` out.

Counterpart of ``fpmash_tpu/ops/walk.py:130 all_pairs_walk``.  The lists
are zero-padded into one ``int64 [R, S]`` tensor per side plus lengths, put
on the chosen device, and walked by :func:`pairwise_walk` in one call (the
kernel on a CUDA device, its plain version on the CPU), or one call a shard
of the query axis over a mesh.  The TPU route's power-of-two step bucket
and rows padded to multiples of 8 are not needed here: the kernel's loop
ends on its own and a launch takes any number of pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from fpmash_tpu_torch.ops.walk_cuda import pairwise_walk



def pad_lists(arrays, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Lists of u64 hashes -> (``int64 [n, S]`` zero-padded, ``int32 [n]`` lengths)."""
    width = max(1, max((len(a) for a in arrays), default=0))
    out = np.zeros((len(arrays), width), np.uint64)
    lens = np.zeros(len(arrays), np.int32)
    for row, a in enumerate(arrays):
        out[row, : len(a)] = np.asarray(a, np.uint64)
        lens[row] = len(a)
    return (
        torch.from_numpy(out.view(np.int64)).to(device),
        torch.from_numpy(lens).to(device),
    )


def all_pairs_walk(refs, qrys, sketch_size: int, *, device, mesh=None):
    """Lists of (unsorted) hash arrays -> ``(common, denom)`` as numpy
    ``int32 [len(refs), len(qrys)]``; with a ``mesh`` of several shards, the
    query axis is sharded over it (``parallel/sharded.shard_queries``, the
    layout of ``sharded_all_pairs_walk``)."""
    from fpmash_tpu_torch.parallel.sharded import mesh_of, shard_queries

    mesh = mesh_of(device, mesh)
    ref, ref_len = pad_lists(refs, mesh[0])
    qry, qry_len = pad_lists(qrys, mesh[0])
    common, denom = shard_queries(pairwise_walk, mesh, ref, ref_len, qry, qry_len, sketch_size)
    return common.cpu().numpy(), denom.cpu().numpy()
