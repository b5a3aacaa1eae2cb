"""Hash lists as the all-pairs kernels take them.

The lists are zero-padded into one ``int64 [R, S]`` tensor plus ``int32``
lengths (the layout of ``fpmash_tpu/ops/walk.py:130 all_pairs_walk``), for
the walk K2 (``ops/walk_cuda.py``), the sorted comparison K9
(``ops/compare_cuda.py``) and the positional comparison
(``ops/compare.py``); the routes over them are in ``models/distance.py``.
The TPU route's power-of-two step bucket and rows padded to multiples of 8
are not needed here: the kernels' loops end on their own and a launch takes
any number of pairs.
"""

from __future__ import annotations

import numpy as np
import torch


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
