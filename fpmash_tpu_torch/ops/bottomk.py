"""Bottom-k distinct MinHash selection (counterpart of :mod:`fpmash_tpu.ops.bottomk`).

Replaces the reference's ``MinHashHeap`` (mash/src/mash/MinHashHeap.cpp):
keep the ``s`` smallest *distinct* hash values with their multiplicities,
admitting a value only once its multiplicity reaches ``min_cov`` (reads
mode ``-m``).  For a fixed multiset the heap's result is order-independent,
so the batch form is sort -> run lengths -> filter -> first ``s``.

The JAX versions are XLA, not Pallas; here they are torch ops (``torch.unique``
sorts and counts), on whatever device the tensors are on.  Hashes are
``int64`` tensors holding the u64 bits, or pairs of ``int32`` planes holding
the u32 bits of their low and high words (``ops/kmers_cuda.py``); they sort
as unsigned by flipping the sign bit.  The all-ones value (``-1``, the pad
pair ``0xFFFFFFFF`` on both planes) is the pad: a real hash equal to it is
dropped, as in the JAX package.

Every device function returns ``(values int64[s], counts int64[s], n, ok)``:
the first ``n`` slots hold values ascending with their counts, the rest the
pad and 0; ``n`` and ``ok`` are Python values.  Counts are 1-filled when
they are not needed (``need_counts`` false and ``min_cov == 1``).  The JAX
package's TPU devices around XLA (row-sort compaction with its overflow
check, staged i64 sums, log-step run counts, ``nonzero`` avoidance) are not
carried over: nothing here can overflow, so ``ok`` only reports whether the
threshold collected enough.  Counts and positions are ``int64``.
"""

from __future__ import annotations

import numpy as np
import torch

from fpmash_tpu_torch.ops.kmers_cuda import join_planes, split_planes
from fpmash_tpu_torch.ops.murmur3 import _SIGN

_PAD32 = 0xFFFFFFFF


def _distinct(x: torch.Tensor):
    """Distinct values of ``x`` (``int64`` u64 bits) ascending as unsigned,
    with their counts; the pad value is dropped."""
    vals, counts = distinct_counts(x)
    real = vals != -1
    return vals[real], counts[real]


def _select(vals, counts, s: int, min_cov: int, need_counts: bool):
    """First ``s`` admitted distinct values, padded; and how many were admitted."""
    if need_counts or min_cov > 1:
        keep = counts >= min_cov
        vals, counts = vals[keep], counts[keep]
    else:
        counts = torch.ones_like(counts)
    n_eligible = vals.numel()
    n = min(n_eligible, s)
    out_v = torch.full((s,), -1, dtype=torch.int64, device=vals.device)
    out_c = torch.zeros((s,), dtype=torch.int64, device=vals.device)
    out_v[:n] = vals[:n]
    out_c[:n] = counts[:n]
    return out_v, out_c, n, n_eligible


def bottom_k_distinct(hashes: torch.Tensor, valid: torch.Tensor, *, s: int, min_cov: int = 1):
    """Bottom-s distinct hashes with counts of a pool (``int64[N]``, live
    where ``valid``), by a full sort.  Returns ``(values, counts, n)``."""
    vals, counts = _distinct(hashes[valid])
    values, counts, n, _ = _select(vals, counts, s, min_cov, need_counts=True)
    return values, counts, n


def bottom_k_threshold_planes(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor, *,
                              s: int, min_cov: int = 1, boost: int = 1,
                              need_counts: bool = True):
    """Threshold-filtered bottom-s over ``int32`` planes.

    Only values whose high word is at most ``t_hi`` are sorted, where
    ``t_hi`` keeps a fraction ``8 s boost / n_valid`` of the hash space
    (float32 arithmetic, as in the JAX package: ``t_hi`` decides ``ok``).
    Every copy of a kept value shares its high word, so counts are exact.
    ``ok`` is true when at least ``s`` values were admitted or the
    threshold took the whole pool; otherwise the caller raises ``boost``.
    """
    n_valid = int(valid.sum())
    frac = min(float(np.float32(8.0 * s * boost) / max(np.float32(n_valid), np.float32(1))), 1.0)
    sat = frac >= 1.0
    t_hi = _PAD32 if sat else int(frac * float(2**32))
    x = join_planes(lo, hi)
    mask = valid & (((x >> 32) & _PAD32) <= t_hi) & (x != -1)
    m = int(mask.sum())
    vals, counts = _distinct(x[mask])
    values, counts, n, n_eligible = _select(vals, counts, s, min_cov, need_counts)
    return values, counts, n, n_eligible >= s or m >= n_valid


def bottom_k_premasked_planes(lo: torch.Tensor, hi: torch.Tensor, all_taken: bool, *,
                              s: int, min_cov: int = 1, need_counts: bool = True,
                              collect_all: bool = False):
    """Bottom-s over planes whose producer already masked dropped lanes to
    the pad pair (kernels K5 and K6); ``all_taken``: the producer's
    threshold was saturated.

    ``ok`` as for :func:`bottom_k_threshold_planes`.  ``collect_all``
    returns every distinct survivor with its exact count in ``s`` slots,
    and ``ok`` then means that none was cut: the reads-mode caller sums
    counts across chunks and applies ``min_cov`` after the merge.  (The
    JAX version's ``expected_s`` sized its row-sort compaction, which this
    one does not have.)
    """
    vals, counts = _distinct(join_planes(lo, hi))
    values, counts, n, n_eligible = _select(vals, counts, s, min_cov, need_counts)
    if collect_all:
        return values, counts, n, n_eligible <= s
    return values, counts, n, n_eligible >= s or bool(all_taken)


def bottom_k_threshold(hashes: torch.Tensor, valid: torch.Tensor, *, s: int, min_cov: int = 1,
                       boost: int = 1, need_counts: bool = True):
    """:func:`bottom_k_threshold_planes` of an ``int64`` pool."""
    lo, hi = split_planes(torch.where(valid, hashes, -1))
    return bottom_k_threshold_planes(lo, hi, valid, s=s, min_cov=min_cov, boost=boost,
                                     need_counts=need_counts)


def distinct_counts(hashes: torch.Tensor):
    """Every distinct value of a pool (``int64[N]`` holding u64 bits),
    ascending as unsigned, with its multiplicity: ``(values int64[D],
    counts int64[D])`` on the pool's device.

    Counterpart of ``distinct_counts_planes`` (``fpmash_tpu/ops/bottomk.py:558``),
    the query side of ``screen``: one ``torch.unique`` of the sign-flipped
    pool (a radix sort on the card) replaces its sort, run-length pass and
    second sort, so counts and positions are ``int64`` and cannot wrap.
    No value is a pad here: the caller passes only valid hashes, and every
    one counts, as in ``np.unique``.
    """
    vals, counts = torch.unique(hashes ^ _SIGN, sorted=True, return_counts=True)
    return vals ^ _SIGN, counts


def bottom_k_host(hashes, s: int, min_cov: int = 1):
    """NumPy parity model of :func:`bottom_k_distinct`."""
    values, counts = np.unique(np.asarray(hashes, dtype=np.uint64), return_counts=True)
    keep = counts >= min_cov
    values, counts = values[keep], counts[keep]
    return values[:s], counts[:s].astype(np.uint32)


def estimate_set_size(values: np.ndarray, s: int, bits: int = 64) -> float:
    """Cardinality estimate from the top (largest kept) hash
    (MinHashHeap.h:45): ``2^bits * s / topHash``."""
    if len(values) < s:
        return float(len(values))
    top = float(values[s - 1])
    if top == 0:
        return float(len(values))
    return (2.0**bits) * s / top


def estimate_multiplicity(counts: np.ndarray) -> float:
    """Mean multiplicity of kept hashes (MinHashHeap.h:44)."""
    if len(counts) == 0:
        return 0.0
    return float(np.sum(counts)) / len(counts)
