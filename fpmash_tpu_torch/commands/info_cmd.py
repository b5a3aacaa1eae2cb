"""`info` — display sketch file information (CommandInfo.cpp:36-346).

A host verb: flags, defaults and output bytes are those of ``python -m
fpmash_tpu info``.

Modes: default padded listing, ``-H`` header only, ``-t`` tabular, ``-c``
count histograms, ``-d`` JSON dump (CommandInfo::writeJson field order)."""

from __future__ import annotations

import sys
from collections import Counter

from fpmash_tpu_torch.commands.common import print_columns
from fpmash_tpu_torch.models.sketch import Sketch
from fpmash_tpu_torch.utils.info_json import write_info_json


def add_parser(sub):
    p = sub.add_parser("info", help="Display information about sketch files.")
    p.add_argument("sketch", metavar="<sketch>")
    p.add_argument("-H", "--header", action="store_true", help="Only show header info.")
    p.add_argument("-t", "--tabular", action="store_true", help="Tabular output, no header.")
    p.add_argument("-c", "--counts", action="store_true", help="Show hash count histograms for each sketch.")
    p.add_argument("-d", "--dump", action="store_true", help="Dump sketches in JSON format.")
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    exclusive = [args.header, args.tabular, args.counts, args.dump]
    if sum(exclusive) > 1:
        print("ERROR: The options -H, -t, -c and -d are mutually incompatible.", file=sys.stderr)
        return 1
    if not args.sketch.endswith(".msh"):
        print(f'ERROR: The file "{args.sketch}" does not look like a sketch.', file=sys.stderr)
        return 1

    sk = Sketch()
    sk.load_msh(args.sketch)
    p = sk.params

    if args.counts:
        if not sk.references:
            print("ERROR: Sketch file contains no sketches.", file=sys.stderr)
            return 1
        if not any(r.counts is not None for r in sk.references):
            print(
                "ERROR: Sketch file does not have hash counts. Re-sketch with -M to use this feature.",
                file=sys.stderr,
            )
            return 1
        sys.stdout.write("#Sketch\tBin\tFrequency\n")
        for r in sk.references:
            if r.counts is None:
                continue
            hist = Counter(int(c) for c in r.counts)
            for bin_, freq in sorted(hist.items()):
                sys.stdout.write(f"{r.name}\t{bin_}\t{freq}\n")
        return 0

    if args.dump:
        sys.stdout.write(write_info_json(sk))
        return 0

    if args.tabular:
        sys.stdout.write("#Hashes\tLength\tID\tComment\n")
        for r in sk.references:
            sys.stdout.write(f"{len(r.hashes)}\t{r.length}\t{r.name}\t{r.comment}\n")
        return 0

    alphabet = "".join(sorted(set(p.alphabet)))
    out = sys.stdout
    out.write("Header:\n")
    out.write(f"  Hash function (seed):          MurmurHash3_x64_128 ({p.seed})\n")
    out.write(f"  K-mer size:                    {p.kmer_size} ({64 if p.use64 else 32}-bit hashes)\n")
    out.write(
        f"  Alphabet:                      {alphabet}"
        f"{'' if p.noncanonical else ' (canonical)'}"
        f"{' (case-sensitive)' if p.preserve_case else ''}\n"
    )
    out.write(f"  Target min-hashes per sketch:  {p.sketch_size}\n")
    out.write(f"  Sketches:                      {len(sk.references)}\n")

    if not args.header:
        out.write("\nSketches:\n")
        columns = [["[Hashes]"], ["[Length]"], ["[ID]"], ["[Comment]"]]
        for r in sk.references:
            columns[0].append(str(len(r.hashes)))
            columns[1].append(str(r.length))
            columns[2].append(r.name)
            columns[3].append(r.comment)
        print_columns(columns)
    return 0
