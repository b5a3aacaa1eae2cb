"""`fingerprint` — Lyndon-factorization fingerprints of reads (lyn2vec/lyn2vec.py:241-287).

The basic pipeline (``--type basic``: every cyclic 100-window, or the whole
read with ``--shift no_shift``) and the generalized one (``--type
generalized``: long reads cut into ``--split``-sized chunks).  Flags,
defaults and output bytes are those of ``python -m fpmash_tpu
fingerprint``; ``--device`` replaces ``--backend``.  The other lyn2vec
verbs, ``generate`` and ``mapping``, are not ported yet.
"""

from __future__ import annotations

import os
import sys

from fpmash_tpu_torch.commands.common import add_device_option
from fpmash_tpu_torch.device import resolve_device
from fpmash_tpu_torch.ops.factorize import plan


def add_parser(sub):
    f = sub.add_parser("fingerprint", help="Compute Lyndon-factorization fingerprints of reads.")
    f.add_argument("--type", dest="mode", default="basic", choices=["basic", "generalized"], help="basic = shift windows; generalized = long-read chunks.")
    f.add_argument("--path", default="", help="Directory containing the FASTA and receiving outputs.")
    f.add_argument("--fasta", required=True, help="Input FASTA/FASTQ/GZ file name.")
    f.add_argument("--type_factorization", default="CFL", help="CFL | ICFL | CFL_ICFL-10/20/30 | CFL_COMB | ICFL_COMB | CFL_ICFL_COMB-10/20/30")
    f.add_argument("--rev_comb", default="false", choices=["true", "false"], help="Reverse-complement twin lines (reference semantics).")
    f.add_argument("--fact", default="create", choices=["create", "no_create"], help="Also write the factor-strings file.")
    f.add_argument("--shift", default="shift", choices=["shift", "no_shift"], help="Basic mode: fingerprint every cyclic 100-window.")
    f.add_argument("--split", type=int, default=300, help="Generalized mode: chunk size. [300]")
    f.add_argument("-n", type=int, default=1, help="Worker count (interface parity; device batching supersedes it).")
    add_device_option(f)
    f.set_defaults(func=run_fingerprint)
    return f


def run_fingerprint(args) -> int:
    from fpmash_tpu_torch.models.fingerprint import (
        extract_long_reads,
        extract_reads,
        fingerprint_long_reads,
        fingerprint_reads,
    )

    device = resolve_device(args.device)
    plan(args.type_factorization)  # an unknown family fails before any work
    fasta = os.path.join(args.path, args.fasta) if args.path else args.fasta
    rev = args.rev_comb == "true"
    with_factors = args.fact == "create"

    if args.mode == "basic":
        reads = extract_reads(fasta, rev_com=rev)
        if not reads:
            print("No reads extracted!", file=sys.stderr)
            return 1
        fp, fac = fingerprint_reads(reads, args.type_factorization, shift=args.shift == "shift",
                                    with_factors=with_factors, device=device)
    else:
        reads = extract_long_reads(fasta, rev_com=rev)
        if not reads:
            print("No reads extracted!", file=sys.stderr)
            return 1
        fp, fac = fingerprint_long_reads(reads, args.type_factorization, split=args.split,
                                         with_factors=with_factors, device=device)

    base = args.path if args.path else "."
    fp_path = os.path.join(base, f"fingerprint_{args.type_factorization}.txt")
    with open(fp_path, "w") as fh:
        fh.writelines(fp)
    if with_factors:
        fac_path = os.path.join(base, f"fact_fingerprint_{args.type_factorization}.txt")
        with open(fac_path, "w") as fh:
            fh.writelines(fac)
    print(f"Wrote {fp_path}", file=sys.stderr)
    return 0
