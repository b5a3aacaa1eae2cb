"""Sorted all-pairs sketch comparison and positional matches: plain versions.

Counterpart of :mod:`fpmash_tpu.ops.compare`.

* :func:`pairwise_common_denom` is the plain version of kernel K9
  (``ops/compare_cuda.py``): for every (reference, query) pair, the union
  merge of the two lists with its cap, in the gather-free formulation of
  the JAX package (``fpmash_tpu/ops/compare.py:37``).  Each pair's live
  elements (those at an index below the list's length and not equal to
  ``2^64 - 1``, the pad) are sorted as one row, ascending unsigned; an
  element equal to its predecessor is a duplicate, the others are run
  starts; ``rank`` counts run starts so far, minus 1, and

      common = #{duplicates with rank < cap},  denom = min(#run starts, cap).

  On sorted distinct lists this is the capped merge-join walk
  (CommandDistance.cpp:365-430); on lists with a repeated hash it counts
  the multiset, which the walk does not.  It takes lists in any order.
* :func:`positional_matches` and :func:`pairwise_positional` are the
  positional fingerprint comparison of ``triangle -fp``
  (CommandTriangle.cpp:265-302), plain PyTorch as in the JAX package (XLA
  there, not Pallas), in blocks of rows.

The all-pairs routes over these, tiled and sharded, are in
``models/distance.py``.

Lists are ``int64 [n, S]`` holding u64 hash bits (``ops/murmur3.py``) with
``int32 [n]`` lengths.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.murmur3 import _SIGN
from fpmash_tpu_torch.ops.walk_cuda import _check

#: elements the plain versions hold in one temporary (bounds their memory)
_PLAIN_ELEMENTS = 1 << 24


def _masked(lists: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``lists`` with every element at an index ``>= len`` set to the pad ``-1``."""
    idx = torch.arange(lists.shape[1], device=lists.device)
    return torch.where(idx[None, :] < lens.to(torch.int64)[:, None], lists, -1)


def pairwise_common_denom(ref: torch.Tensor, ref_len: torch.Tensor, qry: torch.Tensor,
                          qry_len: torch.Tensor, sketch_size: int):
    """Plain version of K9, on any device: ``(common int32[R, Q], denom
    int32[R, Q])``.  Pairs go in chunks whose ``[pairs, S1 + S2]`` rows
    hold at most ``_PLAIN_ELEMENTS`` elements."""
    _check(ref, ref_len, qry, qry_len)
    dev = ref.device
    (R, S1), (Q, S2) = ref.shape, qry.shape
    cap = min(int(sketch_size), 1 << 62)
    common = torch.zeros(R * Q, dtype=torch.int32, device=dev)
    denom = torch.zeros_like(common)
    if S1 + S2 == 0:
        return common.view(R, Q), denom.view(R, Q)
    a, b = _masked(ref, ref_len), _masked(qry, qry_len)
    pad = -1 ^ _SIGN  # the pad after the sign flip: the largest int64
    per = max(1, _PLAIN_ELEMENTS // (S1 + S2))
    for p0 in range(0, R * Q, per):
        pairs = torch.arange(p0, min(p0 + per, R * Q), device=dev)
        x = torch.sort(torch.cat([a[pairs // Q], b[pairs % Q]], dim=1) ^ _SIGN, dim=1).values
        eq_prev = torch.nn.functional.pad(x[:, 1:] == x[:, :-1], (1, 0), value=False)
        live = x != pad
        is_start = ~eq_prev & live
        rank = torch.cumsum(is_start, dim=1) - 1
        common[pairs] = (eq_prev & live & (rank < cap)).sum(dim=1).to(torch.int32)
        denom[pairs] = is_start.sum(dim=1).clamp(max=cap).to(torch.int32)
    return common.view(R, Q), denom.view(R, Q)


def positional_matches(h1: torch.Tensor, l1: torch.Tensor, h2: torch.Tensor,
                       l2: torch.Tensor):
    """Row-wise positional comparison (CommandTriangle.cpp:265): for each
    row, ``matches = sum(h1[i] == h2[i], i < min(l1, l2))``.  Returns
    ``(matches int32[P], n int32[P])`` with ``n = min(l1, l2)``."""
    n = torch.minimum(l1, l2)
    idx = torch.arange(h1.shape[-1], device=h1.device)
    eq = (h1 == h2) & (idx[None, :] < n[:, None])
    return eq.sum(dim=-1).to(torch.int32), n


def pairwise_positional(hashes: torch.Tensor, lens: torch.Tensor, table=None, table_lens=None):
    """Positional matches of the rows ``hashes [N, S]`` against ``table
    [M, S]`` (by default the rows themselves, so all pairs of one set):
    ``matches[a, b] = sum(h[a, i] == t[b, i], i < min(len_a, tlen_b))``, in
    blocks of rows holding at most ``_PLAIN_ELEMENTS`` comparisons.
    Returns ``(matches int32[N, M], n int32[N, M])``."""
    if table is None:
        table, table_lens = hashes, lens
    N, S = hashes.shape
    M = table.shape[0]
    n = torch.minimum(lens[:, None], table_lens[None, :])
    matches = torch.zeros((N, M), dtype=torch.int32, device=hashes.device)
    idx = torch.arange(S, device=hashes.device)
    rows = max(1, _PLAIN_ELEMENTS // max(M * S, 1))
    for r0 in range(0, N, rows):
        blk = hashes[r0 : r0 + rows]
        eq = (blk[:, None, :] == table[None, :, :]) & (idx < n[r0 : r0 + rows, :, None])
        matches[r0 : r0 + rows] = eq.sum(dim=-1).to(torch.int32)
    return matches, n
