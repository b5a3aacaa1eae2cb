"""`contain` — containment of query sketches within references
(CommandContain.cpp).  Output: ``score  error  ref  query`` per pair.

Inputs are ``.msh`` sketches or FASTA/FASTQ files, sketched on ``--device``
(queries with the reference's parameters); the containment walk runs on
the host (``models/distance.contain_sketches``), as in the JAX package.
Flags, defaults and output bytes are those of ``python -m fpmash_tpu
contain``; ``--device`` replaces ``--backend``.
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
from fpmash_tpu_torch.models.distance import contain_sketches
from fpmash_tpu_torch.models.sketch import Sketch
from fpmash_tpu_torch.scalar.stats import format_g


def add_parser(sub):
    p = sub.add_parser(
        "contain",
        help="Estimate the containment of query sequences within references.",
    )
    p.add_argument("reference", metavar="<reference>")
    p.add_argument("queries", nargs="+", metavar="<query>")
    p.add_argument("-l", "--list", action="store_true")
    # default 0.05 matches the reference (CommandContain.cpp:51)
    p.add_argument("-e", "--errorThreshold", type=float, default=0.05, help="Error bound threshold for reporting scores values. Error bounds can generally be increased by increasing the sketch size of the reference. [0.05]")
    p.add_argument("-C", "--comment", action="store_true", help="Show comment fields with reference/query names.")
    add_device_option(p)
    add_sketch_options(p)
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    ref = Sketch(sketch_params_from_args(args))
    ref.init_from_files([args.reference], devices=devices)
    qry = Sketch(ref.params)
    qry.init_from_files(expand_inputs(args.queries, args.list), individual=args.individual,
                        devices=devices)
    for msg in ref.check_compatible(qry):
        print(f"WARNING: {msg}", file=sys.stderr)

    for q in qry.references:
        for r in ref.references:
            score, error = contain_sketches(r.hashes, q.hashes)
            if error > args.errorThreshold:
                continue
            rname = r.name + (":" + r.comment if args.comment else "")
            qname = q.name + (":" + q.comment if args.comment else "")
            sys.stdout.write(f"{format_g(score)}\t{format_g(error)}\t{rname}\t{qname}\n")
    return 0
