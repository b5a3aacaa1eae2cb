"""`dist` — pairwise Mash distance (CommandDistance.cpp:38-333).

Output (plain): ``ref  query  distance  p-value  shared/denom`` per passing
pair, queries outer / references inner; ``-t`` emits a query-rows x
ref-columns distance table.  Inputs are ``.msh`` sketches or FASTA/FASTQ
files, which are sketched first (queries with the reference's
parameters).  With ``-fp``: ``.msh`` inputs load as sketches,
``.txt`` inputs via the fingerprint parser — the reference sniffs only the
*reference* argument's extension (containsMSH/containsTXT,
CommandDistance.cpp:453-475), reproduced here.  Flags, defaults and output
bytes are those of ``python -m fpmash_tpu dist``; ``--device`` replaces
``--backend``.
"""

from __future__ import annotations

import sys

from fpmash_tpu_torch.commands.common import (
    add_device_option,
    add_sketch_options,
    expand_inputs,
    sketch_params_from_args,
)
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.models.distance import all_pairs_dist
from fpmash_tpu_torch.models.sketch import Sketch
from fpmash_tpu_torch.scalar.stats import format_g
from fpmash_tpu_torch.utils.trace import trace


def add_parser(sub):
    p = sub.add_parser(
        "dist",
        help="Estimate the distance of query sketches to references.",
        description="Estimate the Mash distance of each query to each reference.",
    )
    p.add_argument("reference", metavar="<reference>")
    p.add_argument("queries", nargs="+", metavar="<query>")
    p.add_argument("-l", "--list", action="store_true", help="Query files are lists of file names.")
    p.add_argument("-t", "--table", action="store_true", help="Table output (no p-values; blank if below threshold).")
    p.add_argument("-v", "--pvalue", type=float, default=1.0, help="Maximum p-value to report. [1.0]")
    p.add_argument("-d", "--distance", type=float, default=1.0, help="Maximum distance to report. [1.0]")
    p.add_argument("-C", "--comment", action="store_true", help="Show comment fields with reference/query names.")
    p.add_argument("-fp", "--fingerprint", action="store_true", help="Inputs are fingerprints.")
    add_device_option(p)
    add_sketch_options(p)
    p.set_defaults(func=run)
    return p


def load_ref_and_queries(args, devices):
    params = sketch_params_from_args(args, fingerprint=args.fingerprint)
    ref_is_msh = _contains([args.reference], ".msh")

    def load(paths, inherit=None) -> Sketch:
        sk = Sketch(inherit if inherit is not None else params)
        # extension sniffing quirk: driven by the REFERENCE argument only
        if args.fingerprint and _contains(paths, ".msh" if ref_is_msh else ".txt"):
            if ref_is_msh:
                sk.init_from_files(paths, individual=args.individual, devices=devices)
            else:
                sk.init_from_fingerprints(paths, device=devices[0])
        elif args.fingerprint:
            sk.init_from_fingerprints(paths, device=devices[0])
        else:
            sk.init_from_files(paths, individual=args.individual, devices=devices)
        return sk

    ref = load([args.reference])
    # queries inherit the reference sketch's parameters (CommandDistance.cpp:146-155)
    qry = load(expand_inputs(args.queries, args.list), inherit=ref.params)
    for msg in ref.check_compatible(qry):
        print(f"WARNING: {msg}", file=sys.stderr)
    return ref, qry


def _contains(paths, suffix) -> bool:
    flag = False
    for s in paths:
        flag = suffix in s  # last element wins, like the reference
    return flag


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    with trace("load-sketches"):
        ref, qry = load_ref_and_queries(args, devices)
    with trace("distances", pairs=len(ref) * len(qry)):
        results = {
            (ri, qi): res
            for ri, qi, res in all_pairs_dist(
                ref, qry, max_distance=args.distance, max_pvalue=args.pvalue, devices=devices,
            )
        }

    with trace("format-lines", pairs=len(results)):
        _write(results, ref, qry, args)
    return 0


def _write(results, ref, qry, args) -> None:
    """Every passing pair's line, or the ``-t`` table, on standard output."""
    out = sys.stdout
    if args.table:
        out.write("#query\t" + "\t".join(r.name for r in ref.references) + "\n")
        for qi, q in enumerate(qry.references):
            cells = [q.name]
            for ri in range(len(ref.references)):
                res = results[(ri, qi)]
                cells.append(format_g(res.distance) if res.passed else "")
            out.write("\t".join(cells) + "\n")
    else:
        for qi, q in enumerate(qry.references):
            for ri, r in enumerate(ref.references):
                res = results[(ri, qi)]
                if not res.passed:
                    continue
                rname = r.name + (":" + r.comment if args.comment else "")
                qname = q.name + (":" + q.comment if args.comment else "")
                out.write(
                    f"{rname}\t{qname}\t{format_g(res.distance)}\t"
                    f"{format_g(res.pvalue)}\t{res.numer}/{res.denom}\n"
                )
