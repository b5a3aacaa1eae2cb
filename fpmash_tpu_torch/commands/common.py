"""Shared CLI plumbing: the sketch options, parameter setup and ``--device``.

The sketch options are those of ``fpmash_tpu/commands/common.py``
(``Command::useSketchOptions``, Command.cpp:183-228) that bear on the
ported fingerprint path, with the same identifiers and defaults; the
fingerprint override follows sketchParameterSetup.cpp:78-84.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

from fpmash_tpu_torch.models.sketch import SketchParams

ALPHABET_NUCLEOTIDE = "ACGT"


def add_sketch_options(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("sketch options")
    g.add_argument("-k", "--kmer", type=int, default=None, help="K-mer size (1-32); fingerprint mode forces 1. [21]")
    g.add_argument("-s", "--sketch-size", type=int, default=None, help="Sketch size. [1000]")
    g.add_argument("-i", "--individual", action="store_true", help="Sketch individual sequences, rather than whole files.")
    g.add_argument("-S", "--seed", type=int, default=42, help="Seed to provide to the hash function. [42]")
    g.add_argument("-w", "--warning", type=float, default=0.01, help="Probability threshold for warning about low k-mer size.")
    g.add_argument("-Z", "--preserve-case", action="store_true", help="Preserve case in k-mers and alphabets.")
    g.add_argument("-p", "--threads", type=int, default=1, help="Parallelism (kept for interface parity; device batching supersedes it).")


def add_device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device to compute on: cuda (the CUDA kernels; an error if no card "
        "is usable) or cpu (their plain PyTorch versions). [cuda]",
    )


def sketch_params_from_args(args, fingerprint: bool = False) -> SketchParams:
    """sketchParameterSetup.cpp:9-106 semantics for the options above."""
    p = SketchParams()
    if args.kmer is not None:
        p = replace(p, kmer_size=args.kmer)
    if args.sketch_size is not None:
        p = replace(p, sketch_size=args.sketch_size)
    p = replace(
        p,
        concatenated=not args.individual,
        seed=args.seed,
        preserve_case=args.preserve_case,
    )
    if fingerprint:
        return p.for_fingerprint()
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
