"""Mash distance between sketches (CommandDistance.cpp:365-430).

:func:`compare_sketches` is the literal merge-join walk with its union cap,
copied from :mod:`fpmash_tpu.models.distance`: the parity model.
:func:`all_pairs_dist` computes every pair on the chosen devices and follows
the literal walk: where the sorted comparison (kernel K9,
:func:`all_pairs_common_denom`) equals the walk on every pair
(:func:`k9_equals_walk`) the pairs go through it, otherwise through the walk
over the stored order (kernel K2, :func:`all_pairs_walk`), so the
reference's order-dependent result on unsorted fingerprint lists is
reproduced, not "fixed".  The JAX package's
device route sends every non-decreasing list to its sorted comparison,
which counts a repeated hash into ``common`` and prints ``279/1`` where the
walk prints ``130/150``; that is a defect of the reference, not copied.
:func:`compare_fingerprints` is the positional comparison of
``triangle -fp`` (CommandTriangle.cpp:265-302), :func:`contain_sketches`
the containment walk of ``contain``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from fpmash_tpu_torch.ops.walk import pad_lists
from fpmash_tpu_torch.parallel.sharded import (
    sharded_all_pairs,
    sharded_all_pairs_positional,
    sharded_all_pairs_walk,
)
from fpmash_tpu_torch.scalar.stats import chisq_sf, mash_distance, mash_pvalue
from fpmash_tpu_torch.utils.trace import trace

#: pairs per launch of :func:`all_pairs_common_denom` (8 bytes of output each)
_TILE_PAIRS = 1 << 26


@dataclass
class PairResult:
    passed: bool = False
    numer: int = 0
    denom: int = 0
    distance: float = 1.0
    pvalue: float = 1.0


def compare_sketches(
    ref_hashes: np.ndarray,
    qry_hashes: np.ndarray,
    ref_length: int,
    qry_length: int,
    sketch_size: int,
    kmer_size: int,
    kmer_space: float,
    max_distance: float = -1.0,
    max_pvalue: float = -1.0,
) -> PairResult:
    """Literal merge-join walk of CommandDistance::compareSketches."""
    A = ref_hashes
    B = qry_hashes
    i = j = 0
    common = 0
    denom = 0
    la, lb = len(A), len(B)
    while denom < sketch_size and i < la and j < lb:
        a, b = A[i], B[j]
        if a < b:
            i += 1
        elif b < a:
            j += 1
        else:
            i += 1
            j += 1
            common += 1
        denom += 1
    if denom < sketch_size:
        if i < la:
            denom += la - i
        if j < lb:
            denom += lb - j
        if denom > sketch_size:
            denom = sketch_size
    return pair_result(common, denom, ref_length, qry_length, kmer_size, kmer_space,
                       max_distance, max_pvalue)


def compare_fingerprints(
    hashes1: np.ndarray,
    hashes2: np.ndarray,
    max_distance: float = 1.0,
    max_pvalue: float = 1.0,
) -> PairResult:
    """Positional fingerprint comparison (CommandTriangle.cpp:265-302):
    matches counted index-by-index over the unsorted lists,
    ``d = 1 - matches/minSize``, p = chisq_Q(matches, 1)."""
    out = PairResult()
    n = min(len(hashes1), len(hashes2))
    matches = int(np.sum(hashes1[:n] == hashes2[:n])) if n else 0
    out.distance = 1.0 - (matches / n) if n else 1.0
    out.pvalue = chisq_sf(matches, 1)
    out.numer = matches
    out.denom = n
    out.passed = out.distance <= max_distance and out.pvalue <= max_pvalue
    return out


def contain_sketches(ref_hashes: np.ndarray, qry_hashes: np.ndarray) -> tuple[float, float]:
    """Containment of query in reference (CommandContain.cpp:368-415):
    returns ``(score, error)`` = ``(common/denom, 1/sqrt(j))``, the walk
    over two sorted u64 lists on the host, as in the JAX package."""
    A, B = ref_hashes, qry_hashes
    denom = min(len(A), len(B))
    i = j = common = 0
    steps = 0
    # Each counted step advances j exactly once, so j <= denom <= len(B);
    # advancing only i is uncounted (steps-- in the reference).
    while steps < denom and i < len(A):
        if A[i] < B[j]:
            i += 1
            continue
        if B[j] < A[i]:
            j += 1
        else:
            i += 1
            j += 1
            common += 1
        steps += 1
    error = 1.0 / math.sqrt(j) if j else 1.0
    return (common / denom if denom else 0.0), error


def pair_distance(common: int, denom: int, kmer_size: int) -> float:
    """The Mash distance of a pair's ``common/denom`` (0 when they are equal)."""
    return 0.0 if common == denom else mash_distance(common / denom, kmer_size)


def pair_result(common: int, denom: int, ref_length: int, qry_length: int, kmer_size: int,
                kmer_space: float, max_distance: float = -1.0,
                max_pvalue: float = -1.0) -> PairResult:
    """:func:`compare_sketches`' result from a pair's ``common`` and ``denom``."""
    out = PairResult()
    distance = pair_distance(common, denom, kmer_size)
    if 0 <= max_distance < distance:
        return out
    out.numer, out.denom, out.distance = common, denom, distance
    out.pvalue = mash_pvalue(common, ref_length, qry_length, kmer_space, denom)
    if 0 <= max_pvalue < out.pvalue:
        return out
    out.passed = True
    return out


#: the sorted comparison's pad, 2^64 - 1
_PAD = (1 << 64) - 1


def k9_equals_walk(hashes_lists) -> bool:
    """Whether the sorted comparison K9 gives the literal walk's ``common``
    and ``denom`` on every pair of these hash lists.  It does when every
    list is strictly increasing and none ends in 2^64 - 1: K9 counts a
    repeated hash as a multiset, which the walk does not, and drops 2^64 - 1
    as its pad, which the walk keeps (in a strictly increasing list only the
    last and largest hash can equal it).  Classic sketches hold no repeat
    and no pad, so they take K9."""
    return all(
        len(h) < 2 or bool(np.all(h[:-1] < h[1:])) for h in hashes_lists
    ) and not any(len(h) and int(h[-1]) == _PAD for h in hashes_lists)


def all_pairs_common_denom(refs, qrys, sketch_size: int, *, devices):
    """Lists of sorted hash arrays -> ``(common, denom)`` as numpy
    ``int32 [len(refs), len(qrys)]``, through K9 (``ops/compare_cuda.py``; its
    plain version on the CPU).  The lists go to ``devices[0]`` once, and the
    kernel runs over blocks of reference rows of ``_TILE_PAIRS`` pairs, so
    that the ``[rows, Q]`` outputs of one launch stay bounded (a RefSeq-size
    reference set does not fit one launch's outputs); the query axis of each
    block is sharded over ``devices`` (``parallel/sharded.sharded_all_pairs``).
    The TPU route's multiple-of-8 padding, ``c << 16 | d`` packing and
    in-flight window are not needed."""
    ref, ref_len = pad_lists(refs, devices[0])
    qry, qry_len = pad_lists(qrys, devices[0])
    R, Q = len(refs), len(qrys)
    common = np.zeros((R, Q), np.int32)
    denom = np.zeros((R, Q), np.int32)
    rows = max(1, _TILE_PAIRS // max(Q, 1))
    for r0 in range(0, R, rows):
        c, d = sharded_all_pairs(devices, ref[r0 : r0 + rows], ref_len[r0 : r0 + rows], qry,
                                 qry_len, sketch_size)
        common[r0 : r0 + rows] = c.cpu().numpy()
        denom[r0 : r0 + rows] = d.cpu().numpy()
    return common, denom


def all_pairs_walk(refs, qrys, sketch_size: int, *, devices):
    """Lists of (unsorted) hash arrays -> ``(common, denom)`` as numpy
    ``int32 [len(refs), len(qrys)]``, walked in their stored order by K2
    (``ops/walk_cuda.py``; its plain version on the CPU) in one call a shard
    of the query axis over ``devices`` (``parallel/sharded.sharded_all_pairs_walk``).
    Counterpart of ``fpmash_tpu/ops/walk.py:130``."""
    ref, ref_len = pad_lists(refs, devices[0])
    qry, qry_len = pad_lists(qrys, devices[0])
    common, denom = sharded_all_pairs_walk(devices, ref, ref_len, qry, qry_len, sketch_size)
    return common.cpu().numpy(), denom.cpu().numpy()


def all_pairs_positional(fingerprint_hashes, *, devices):
    """List of (unsorted) hash arrays -> ``(matches, minlen)`` as numpy
    ``int32 [N, N]``, for the fingerprint triangle (``ops/compare.py``'s
    positional comparison), the rows sharded over ``devices``."""
    h, lens = pad_lists(fingerprint_hashes, devices[0])
    matches, n = sharded_all_pairs_positional(devices, h, lens)
    return matches.cpu().numpy(), n.cpu().numpy()


def common_denom(refs, qrys, sketch_size: int, *, devices):
    """``(common, denom)`` numpy ``int32 [len(refs), len(qrys)]`` of every
    pair, the literal walk's: through the sorted comparison K9
    (:func:`all_pairs_common_denom`) where :func:`k9_equals_walk` holds for
    both sides, through the walk K2 (:func:`all_pairs_walk`) over the lists in
    their stored order otherwise.  ``dist`` and ``triangle`` both route here.
    Either kernel's query axis is sharded over ``devices``; the route does
    not depend on how many there are."""
    pairs = len(refs) * len(qrys)
    if k9_equals_walk(refs) and (qrys is refs or k9_equals_walk(qrys)):
        with trace("all-pairs-compare", pairs=pairs, shards=len(devices)):
            return all_pairs_common_denom(refs, qrys, sketch_size, devices=devices)
    with trace("all-pairs-walk", pairs=pairs, shards=len(devices)):
        return all_pairs_walk(refs, qrys, sketch_size, devices=devices)


def all_pairs_dist(
    ref_sketch,
    qry_sketch,
    max_distance: float = -1.0,
    max_pvalue: float = -1.0,
    *,
    devices,
):
    """Ref x query pairwise Mash distance (CommandDistance::run semantics).

    Yields ``(ref_index, qry_index, PairResult)`` in output order: queries
    outer, references inner (CommandDistance.cpp:335-360).  The effective
    sketch size is the min of the two (CommandDistance.cpp:343).  Every
    pair gets the literal walk's counts at every size, as the JAX package's
    host route gives them below 64 pairs: :func:`common_denom` sends the
    pairs through the sorted comparison K9 when :func:`k9_equals_walk` holds
    for the lists of both sketches (so for every classic sketch), otherwise
    through the walk K2, as for ``triangle``.  The JAX device route
    (``fpmash_tpu/models/distance.py:166-221``) takes its sorted comparison
    for every non-decreasing list and reports ``common > denom`` on a
    repeated hash; the port does not copy that defect.  ``devices``: see
    :func:`common_denom`.
    """
    sketch_size = min(ref_sketch.params.sketch_size, qry_sketch.params.sketch_size)
    k = ref_sketch.params.kmer_size
    space = ref_sketch.params.kmer_space
    common, denom = common_denom(
        [r.hashes for r in ref_sketch.references],
        [q.hashes for q in qry_sketch.references],
        sketch_size,
        devices=devices,
    )
    with trace("pair-results", pairs=common.size):
        for qi, q in enumerate(qry_sketch.references):
            for ri, r in enumerate(ref_sketch.references):
                yield ri, qi, pair_result(int(common[ri, qi]), int(denom[ri, qi]), r.length,
                                          q.length, k, space, max_distance, max_pvalue)
