"""lyn2vec verbs: `generate`, `fingerprint`, `mapping` (lyn2vec/lyn2vec.py:241-287).

* ``generate`` — pseudo-random DNA FASTA/FASTQ files (dna_utils.py:71),
  drawn from Python's ``random.Random(seed)`` as in the JAX package, so a
  seeded run writes the same bytes.
* ``fingerprint`` — the basic pipeline (``--type basic``: every cyclic
  100-window, or the whole read with ``--shift no_shift``) and the
  generalized one (``--type generalized``: long reads cut into
  ``--split``-sized chunks), on ``--device`` (in place of ``--backend``).
* ``mapping`` — fingerprint -> Unicode-alphabet projection
  (fingerprint_utils.py:377-398).

Flags, defaults and output bytes are those of ``python -m fpmash_tpu``'s
verbs of the same names.
"""

from __future__ import annotations

import os
import sys

from fpmash_tpu_torch.commands.common import add_device_option
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.ops.factorize import plan


def add_parsers(sub):
    g = sub.add_parser("generate", help="Generate pseudo-random DNA sequence files.")
    g.add_argument("--path", default="generated", help="Output file path/prefix (extension appended).")
    g.add_argument("--format", default="fasta", choices=["fasta", "fa", "fastq"])
    g.add_argument("--size", type=int, required=True, help="Size of each DNA sequence in bp.")
    g.add_argument("--number_dna_generate", type=int, required=True, help="Number of sequences to generate.")
    g.add_argument("--gc_content", type=float, default=0.5, help="GC content in [0, 1].")
    g.add_argument("--seed", type=int, default=None, help="PRNG seed (the reference is unseeded).")
    g.set_defaults(func=run_generate)

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

    m = sub.add_parser("mapping", help="Map fingerprints to a Unicode character projection.")
    m.add_argument("--path", default="", help="Directory containing the fingerprint file.")
    m.add_argument("--fingerprint", required=True, help="Fingerprint .txt file name.")
    m.set_defaults(func=run_mapping)


def run_generate(args) -> int:
    import random

    from fpmash_tpu_torch.utils.dna import (
        generate_dna_sequences,
        generate_gene_id,
        generate_transcript_id,
    )
    from fpmash_tpu_torch.utils.fasta import write_fasta, write_fastq

    rng = random.Random(args.seed)
    seqs = generate_dna_sequences(args.number_dna_generate, args.size, args.gc_content, rng)
    records = []
    for seq in seqs:
        tid = generate_transcript_id(rng)
        records.append((f"{tid} {generate_gene_id(tid)}", seq))
    out = f"{args.path}.{args.format}"
    if args.format == "fastq":
        write_fastq(out, records)
    else:
        write_fasta(out, records)
    print(f"File {out} generato con successo.", file=sys.stderr)
    return 0


def run_fingerprint(args) -> int:
    from fpmash_tpu_torch.models.fingerprint import (
        extract_long_reads,
        extract_reads,
        fingerprint_long_reads,
        fingerprint_reads,
    )

    device = placement.resolve_devices(args.device)[0]
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


def run_mapping(args) -> int:
    from fpmash_tpu_torch.utils.mapping import mapping_projection

    src = os.path.join(args.path, args.fingerprint) if args.path else args.fingerprint
    lines = mapping_projection(src)
    base = args.path if args.path else "."
    out = os.path.join(base, f"mapped_{args.fingerprint}.txt")
    with open(out, "w") as fh:
        fh.writelines(lines)
    print(f"Wrote {out}", file=sys.stderr)
    return 0
