"""`sketch` — create sketches (CommandSketch.cpp:20-123).

Classic k-mer MinHash sketches of FASTA/FASTQ files (one per file, per
record with ``-i``, or one of all reads with ``-r``), windowed sketches with
``-W`` (one per record, minmer loci, written as ``.msw``), fingerprint sketches
with ``--direct-fp`` (FASTA -> shift windows -> factorization of any of the
ten lyn2vec families -> hash) and ``-fp`` (fingerprint ``.txt`` -> hash).
Flags, defaults and output bytes are those of ``python -m fpmash_tpu
sketch``; ``--device`` replaces ``--backend``.
"""

from __future__ import annotations

import sys
from dataclasses import replace

from fpmash_tpu_torch.commands.common import (
    add_device_option,
    add_sketch_options,
    expand_inputs,
    sketch_params_from_args,
)
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.models.sketch import Sketch
from fpmash_tpu_torch.utils.trace import trace


def add_parser(sub):
    p = sub.add_parser(
        "sketch",
        help="Create sketches (reduced representations for fast operations).",
        description="Create a sketch file from FASTA/FASTQ inputs, from fingerprint "
        ".txt files (-fp), or from FASTA reads fingerprinted on the device (--direct-fp).",
    )
    p.add_argument("inputs", nargs="+", metavar="<input>")
    p.add_argument("-l", "--list", action="store_true", help="Lines in each <input> specify paths to sequence files, one per line.")
    p.add_argument("-o", "--prefix", default=None, help="Output prefix (first input file used if unspecified). '.msh' appended.")
    p.add_argument("-I", "--id", default=None, help="ID field for sketch of reads (instead of first sequence ID).")
    p.add_argument("-C", "--comment", default=None, help="Comment for a sketch of reads (instead of first sequence comment).")
    p.add_argument("-M", "--counts", action="store_true", help="Store multiplicity of each k-mer in each sketch.")
    p.add_argument("-fp", "--fingerprint", action="store_true", help="Inputs are fingerprint .txt files instead of sequences.")
    p.add_argument("--direct-fp", action="store_true", help="Integrated pipeline: FASTA inputs are fingerprinted (shift windows + factorization) and sketched in one on-device pass, skipping the .txt round-trip. Equivalent to lyn2vec + sketch -fp.")
    p.add_argument("--factorization", default="CFL", help="Factorization for --direct-fp: CFL | ICFL | CFL_ICFL-10/20/30 | CFL_COMB | ICFL_COMB | CFL_ICFL_COMB-10/20/30. [CFL]")
    p.add_argument("--rev-comb", default="true", choices=["true", "false"], help="extract_reads rev_com mode for --direct-fp. [true]")
    p.add_argument("--shift", default="shift", choices=["shift", "no_shift"], help="--direct-fp: fingerprint every cyclic 100-window (shift) or the whole read (no_shift), like the lyn2vec flag. [shift]")
    add_device_option(p)
    add_sketch_options(p)
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    files = expand_inputs(args.inputs, args.list)

    if args.direct_fp:
        from fpmash_tpu_torch.models.fingerprint import extract_reads

        sketch = Sketch(sketch_params_from_args(args, fingerprint=True))
        reads = []
        with trace("read-fasta", files=len(files)):
            for f in files:
                reads.extend(extract_reads(f, rev_com=args.rev_comb == "true"))
        sketch.init_from_reads_fingerprint(
            reads, args.factorization, shift=args.shift == "shift", devices=devices
        )
        prefix = args.prefix or files[0]
        out = prefix if prefix.endswith(".msh") else prefix + ".msh"
        print(f"Writing to {out}...", file=sys.stderr)
        sketch.write_msh(out)
        return 0

    params = sketch_params_from_args(args, fingerprint=args.fingerprint)
    if args.counts:
        params = replace(params, counts=True)
    sketch = Sketch(params)
    if args.fingerprint:
        sketch.init_from_fingerprints(files, device=devices[0])
    elif params.reads:
        sketch.init_from_reads(files, devices=devices)
    else:
        sketch.init_from_files(files, individual=args.individual, devices=devices)
    if args.id is not None and sketch.references:
        sketch.references[0].name = args.id
    if args.comment is not None and sketch.references:
        sketch.references[0].comment = args.comment
    sketch._create_index()

    prefix = args.prefix or (args.inputs[0] if args.inputs[0] != "-" else "stdin")
    # windowed sketches use the .msw suffix (CommandSketch.cpp:112-115)
    suffix = ".msw" if params.windowed else ".msh"
    out = prefix if prefix.endswith(suffix) else prefix + suffix
    print(f"Writing to {out}...", file=sys.stderr)
    sketch.write_msh(out)
    return 0
