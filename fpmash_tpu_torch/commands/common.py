"""Shared CLI plumbing: the sketch options, parameter setup and ``--device``.

The sketch options are those of ``fpmash_tpu/commands/common.py``
(``Command::useSketchOptions``, Command.cpp:183-228), with the same
identifiers and defaults, and the parameter setup follows
sketchParameterSetup.cpp:9-106, including the fingerprint, protein and
alphabet overrides, and the windowed ones of ``-W``.  ``--device`` becomes
devices in ``device.resolve_devices``.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from fpmash_tpu_torch.models.sketch import SketchParams

ALPHABET_PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
ALPHABET_NUCLEOTIDE = "ACGT"


def add_sketch_options(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("sketch options")
    g.add_argument("-k", "--kmer", type=int, default=None, help="K-mer size (1-32). [21]")
    g.add_argument("-s", "--sketch-size", type=int, default=None, help="Sketch size. [1000]")
    g.add_argument("-i", "--individual", action="store_true", help="Sketch individual sequences, rather than whole files.")
    g.add_argument("-S", "--seed", type=int, default=42, help="Seed to provide to the hash function. [42]")
    g.add_argument("-w", "--warning", type=float, default=0.01, help="Probability threshold for warning about low k-mer size.")
    g.add_argument("-r", "--reads", action="store_true", help="Input is a read set.")
    g.add_argument("-b", "--bloom", type=str, default=None, metavar="size", help="Use a Bloom filter of this size (implies -r).")
    g.add_argument("-m", "--min-cov", type=int, default=1, help="Minimum copies of each k-mer required to pass noise filter for reads. Implies -r. [1]")
    g.add_argument("-c", "--target-cov", type=float, default=0.0, help="Target coverage. Sketching will conclude if this coverage is reached before the end of the input file (estimated by average k-mer multiplicity). Implies -r.")
    g.add_argument("-g", "--genome", type=str, default=None, metavar="size", help="Genome size (implies -r; raw estimate used otherwise).")
    g.add_argument("-n", "--noncanonical", action="store_true", help="Preserve strand (by default, strand is ignored by using canonical DNA k-mers).")
    g.add_argument("-a", "--amino", action="store_true", dest="protein", help="Use amino acid alphabet (A-Y, except BJOUXZ). Implies -n, -k 9.")
    g.add_argument("-z", "--alphabet", type=str, default=None, help="Alphabet to base hashes on (case ignored by default). Implies -n.")
    g.add_argument("-Z", "--preserve-case", action="store_true", help="Preserve case in k-mers and alphabets.")
    g.add_argument("-p", "--threads", type=int, default=1, help="Parallelism (kept for interface parity; device batching supersedes it).")
    # windowed ("minmer") sketching: gated behind COMMAND_FIND in the
    # reference's default build (sketchParameterSetup.cpp:20-24), always
    # available here, as in the JAX package (Command.cpp:186-188)
    g.add_argument("-W", "--windowed", action="store_true", help="Windowed: store hashes that are minima in any window of -L size, with their positions (.msw output).")
    g.add_argument("-L", "--window", type=int, default=10000, help="Window length for -W. Hashes that are minima in any window of this size will be stored. [10000]")


def add_device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device to compute on: cuda (the CUDA kernels on every visible card, "
        "at most FPMASH_DEVICES of them; an error if no card is usable), cuda:N "
        "(card N alone) or cpu (the kernels' plain PyTorch versions). [cuda]",
    )


def parse_size(text: str | None) -> int:
    """Parse '10M'-style sizes (Command.cpp getArgumentAsNumber for sizes)."""
    if text is None:
        return 0
    text = text.strip().upper()
    mult = 1
    if text and text[-1] in "KMGT":
        # decimal multipliers, like the reference (Command.cpp:124-127)
        mult = 1000 ** ("KMGT".index(text[-1]) + 1)
        text = text[:-1]
    return int(float(text) * mult)


def sketch_params_from_args(args, fingerprint: bool = False) -> SketchParams:
    """sketchParameterSetup.cpp:9-106 semantics."""
    p = SketchParams()
    if args.kmer is not None:
        p = replace(p, kmer_size=args.kmer)
    if args.sketch_size is not None:
        p = replace(p, sketch_size=args.sketch_size)
    p = replace(
        p,
        concatenated=not args.individual,
        noncanonical=args.noncanonical,
        seed=args.seed,
        reads=args.reads,
        min_cov=args.min_cov,
        target_cov=args.target_cov,
    )
    if args.bloom is not None or args.min_cov > 1 or args.target_cov > 0 or args.genome:
        p = replace(p, reads=True)
    if args.bloom is not None:
        # memory-bounded approximate admission (MinHashHeap.cpp:19-41, 78-95)
        p = replace(p, bloom_bytes=parse_size(args.bloom))
    if p.reads:
        p = replace(p, counts=True)
    if p.reads and not p.concatenated:
        print("ERROR: The option -i cannot be used with -r.", file=sys.stderr)
        raise SystemExit(1)
    p = replace(p, preserve_case=args.preserve_case)
    if getattr(args, "windowed", False):
        # COMMAND_FIND builds force per-sequence references
        # (sketchParameterSetup.cpp:20-24: concatenated = false)
        p = replace(p, windowed=True, window_size=args.window, concatenated=False)

    if fingerprint:
        return p.for_fingerprint()
    if args.protein:
        p = replace(p, noncanonical=True, alphabet=ALPHABET_PROTEIN)
        return p if args.kmer is not None else replace(p, kmer_size=9)
    if args.alphabet:
        return replace(p, noncanonical=True, alphabet=args.alphabet)
    return replace(p, alphabet=ALPHABET_NUCLEOTIDE)


def split_file(path: str) -> list[str]:
    """File-of-filenames expansion (Command.cpp splitFile)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(line)
    return out


def expand_inputs(arguments: list[str], list_mode: bool) -> list[str]:
    files = []
    for a in arguments:
        if list_mode:
            files.extend(split_file(a))
        else:
            files.append(a)
    return files


def print_columns(columns: list[list[str]], indent: int = 2, pad: int = 2, fh=None):
    """Padded column output (Command.cpp printColumns)."""
    fh = fh or sys.stdout
    widths = [max((len(c) for c in col), default=0) for col in columns]
    for row in range(max(len(c) for c in columns)):
        line = " " * indent
        for ci, col in enumerate(columns):
            cell = col[row] if row < len(col) else ""
            if ci < len(columns) - 1:
                line += cell.ljust(widths[ci] + pad)
            else:
                line += cell
        fh.write(line.rstrip() + "\n")
