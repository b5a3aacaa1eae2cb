"""Mash distance between sketches (CommandDistance.cpp:365-430).

:func:`compare_sketches` is the literal merge-join walk with its union cap,
copied from :mod:`fpmash_tpu.models.distance`: the parity model.
:func:`all_pairs_dist` runs the same walk for every pair on the chosen
device (``ops/walk.py``), over lists in their stored order, so the
reference's order-dependent result on unsorted fingerprint lists is
reproduced, not "fixed".  Sorted lists take the same walk, which on them
equals the closed-form sorted comparison.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fpmash_tpu_torch.scalar.stats import mash_distance, mash_pvalue


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
    out = PairResult()
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
    jaccard = common / denom if denom else 0.0
    distance = mash_distance(jaccard, kmer_size) if denom else 1.0
    if common == denom:
        distance = 0.0
    if 0 <= max_distance < distance:
        return out
    out.numer = common
    out.denom = denom
    out.distance = distance
    out.pvalue = mash_pvalue(common, ref_length, qry_length, kmer_space, denom)
    if 0 <= max_pvalue < out.pvalue:
        return out
    out.passed = True
    return out


def all_pairs_dist(
    ref_sketch,
    qry_sketch,
    max_distance: float = -1.0,
    max_pvalue: float = -1.0,
    *,
    device,
):
    """Ref x query pairwise Mash distance (CommandDistance::run semantics).

    Yields ``(ref_index, qry_index, PairResult)`` in output order: queries
    outer, references inner (CommandDistance.cpp:335-360).  The effective
    sketch size is the min of the two (CommandDistance.cpp:343).  Every pair
    goes through the walk on ``device``.
    """
    from fpmash_tpu_torch.ops.walk import all_pairs_walk
    from fpmash_tpu_torch.utils.trace import trace

    sketch_size = min(ref_sketch.params.sketch_size, qry_sketch.params.sketch_size)
    k = ref_sketch.params.kmer_size
    space = ref_sketch.params.kmer_space
    with trace("all-pairs-walk", pairs=len(ref_sketch) * len(qry_sketch)):
        common, denom = all_pairs_walk(
            [r.hashes for r in ref_sketch.references],
            [q.hashes for q in qry_sketch.references],
            sketch_size,
            device=device,
        )
    for qi, q in enumerate(qry_sketch.references):
        for ri, r in enumerate(ref_sketch.references):
            c, d = int(common[ri, qi]), int(denom[ri, qi])
            out = PairResult()
            distance = 0.0 if c == d else mash_distance(c / d, k)
            if 0 <= max_distance < distance:
                yield ri, qi, out
                continue
            out.numer, out.denom, out.distance = c, d, distance
            out.pvalue = mash_pvalue(c, r.length, q.length, space, d)
            if 0 <= max_pvalue < out.pvalue:
                yield ri, qi, out
                continue
            out.passed = True
            yield ri, qi, out
