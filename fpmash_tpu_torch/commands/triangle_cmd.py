"""`triangle` — all-pairs lower-triangular matrix (CommandTriangle.cpp:25-238).

Default output: relaxed Phylip — first line the sequence count, then one
row per reference with tab-separated distances to earlier references.
``-E`` (or any of -v/-d) switches to an edge list.  With ``-fp`` the
comparison is the *positional* ``compareFingerprints``
(CommandTriangle.cpp:265-302) instead of the merge-join.  Flags, defaults
and output bytes are those of ``python -m fpmash_tpu triangle``;
``--device`` replaces ``--backend``.

The whole ``[n, n]`` block is computed in one call on the device and its
lower triangle read.  The JAX package compares classic pairs with the
literal walk; here, where the sorted comparison equals the walk
(``models/distance.k9_equals_walk``; ``common_denom`` routes ``dist`` and
``triangle`` alike), the block goes through the sorted comparison K9,
otherwise through the walk K2 over the stored order.  The
positional block is plain PyTorch on the device, its p-values one
vectorised ``chisq_sf``.  Phylip output prints no p-value, so none is
computed for it.
"""

from __future__ import annotations

import sys

import numpy as np

from fpmash_tpu_torch.commands.common import (
    add_device_option,
    add_sketch_options,
    expand_inputs,
    sketch_params_from_args,
)
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.models.distance import (
    PairResult,
    all_pairs_positional,
    common_denom,
    pair_distance,
    pair_result,
)
from fpmash_tpu_torch.models.sketch import Sketch
from fpmash_tpu_torch.scalar.stats import chisq_sf, format_g
from fpmash_tpu_torch.utils.trace import trace


def add_parser(sub):
    p = sub.add_parser(
        "triangle",
        help="Estimate a lower-triangular distance matrix.",
    )
    p.add_argument("inputs", nargs="+", metavar="<seq>")
    p.add_argument("-l", "--list", action="store_true")
    p.add_argument("-C", "--comment", action="store_true", help="Use comment fields for sequence names instead of IDs.")
    p.add_argument("-E", "--edge", action="store_true", help="Output edge list instead of Phylip matrix.")
    p.add_argument("-v", "--pvalue", type=float, default=None, help="Maximum p-value to report in edge list. Implies -E.")
    p.add_argument("-d", "--distance", type=float, default=None, help="Maximum distance to report in edge list. Implies -E.")
    p.add_argument("-fp", "--fingerprint", action="store_true")
    add_device_option(p)
    add_sketch_options(p)
    p.set_defaults(func=run)
    return p


def _positional_results(hashes, edge: bool, max_d: float, max_p: float, devices):
    """``result(i, j)`` of the positional comparison for every pair."""
    with trace("all-pairs-positional", pairs=len(hashes) ** 2):
        matches, minlen = all_pairs_positional(hashes, devices=devices)
    distance = np.where(minlen > 0, 1.0 - matches / np.maximum(minlen, 1), 1.0)
    pvalue = chisq_sf(matches, 1) if edge else None

    def result(i, j):
        res = PairResult(numer=int(matches[i, j]), denom=int(minlen[i, j]),
                         distance=float(distance[i, j]))
        if edge:
            res.pvalue = float(pvalue[i, j])
            res.passed = res.distance <= max_d and res.pvalue <= max_p
        return res

    return result


def _merge_results(sk: Sketch, edge: bool, max_d: float, max_p: float, devices):
    """``result(i, j)`` of the merge-join comparison for every pair."""
    p = sk.params
    hashes = [r.hashes for r in sk.references]
    common, denom = common_denom(hashes, hashes, p.sketch_size, devices=devices)

    def result(i, j):
        c, d = int(common[i, j]), int(denom[i, j])
        if not edge:
            return PairResult(distance=pair_distance(c, d, p.kmer_size))
        return pair_result(c, d, sk.references[i].length, sk.references[j].length,
                           p.kmer_size, p.kmer_space, max_d, max_p)

    return result


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    edge = args.edge or args.pvalue is not None or args.distance is not None
    max_p = args.pvalue if args.pvalue is not None else 1.0
    max_d = args.distance if args.distance is not None else 1.0

    params = sketch_params_from_args(args, fingerprint=args.fingerprint)
    files = expand_inputs(args.inputs, args.list)
    individual = args.individual or (len(files) == 1 and not args.list)

    sk = Sketch(params)
    txt_inputs = [f for f in files if f.endswith(".txt")]
    other_inputs = [f for f in files if not f.endswith(".txt")]
    with trace("load-sketches"):
        if args.fingerprint and txt_inputs:
            sk.init_from_fingerprints(txt_inputs, device=devices[0])
        if other_inputs:
            sk.init_from_files(other_inputs, individual=individual, devices=devices)

    n = len(sk.references)
    if args.fingerprint:
        result = _positional_results([r.hashes for r in sk.references], edge, max_d, max_p,
                                     devices)
    else:
        result = _merge_results(sk, edge, max_d, max_p, devices)

    with trace("format-lines", pairs=n * (n - 1) // 2):
        _write(sk, result, edge, args.comment)
    return 0


def _write(sk: Sketch, result, edge: bool, comment: bool) -> None:
    """The Phylip matrix, or with ``edge`` the passing pairs' lines, on
    standard output; ``result(i, j)`` computes each pair as it is written."""
    n = len(sk.references)
    out = sys.stdout
    if not edge:
        out.write(f"\t{n}\n")
    for i in range(n):
        ref = sk.references[i]
        label = ref.comment if comment else ref.name
        if not edge:
            out.write(label)
        for j in range(i):
            res = result(i, j)
            if edge:
                if res.passed:
                    other = sk.references[j]
                    olabel = other.comment if comment else other.name
                    out.write(
                        f"{label}\t{olabel}\t{format_g(res.distance)}\t"
                        f"{format_g(res.pvalue)}\t{res.numer}/{res.denom}\n"
                    )
            else:
                out.write(f"\t{format_g(res.distance)}")
        if not edge:
            out.write("\n")
