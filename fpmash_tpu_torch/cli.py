"""`fpmash` on PyTorch + CUDA — the CLI, with every verb of ``python -m fpmash_tpu``.

Run ``python -m fpmash_tpu_torch <command> ...``.  The Mash verbs
(mash.cpp:21-39): ``sketch`` (classic k-mer MinHash of FASTA/FASTQ, ``-W``
windowed ``.msw``, ``-fp`` and ``--direct-fp``), ``dist``, ``triangle``
(Phylip, ``-E``, ``-fp``), ``screen`` (streaming, ``-w``, ``-s``, ``-fp``),
``taxscreen``, ``contain``, ``paste``, ``info`` (``-H``, ``-t``, ``-c``,
``-d``), ``bounds`` and ``find``; and the lyn2vec verbs (lyn2vec.py:241-287)
``generate``, ``fingerprint`` and ``mapping``.  Flags and output bytes
match ``python -m fpmash_tpu``.  Every verb that computes on a device takes
``--device`` (default ``cuda``, an error without a card; ``--device cpu``
runs the kernels' plain PyTorch versions), for example
``python -m fpmash_tpu_torch triangle -E a.msh --device cpu`` or
``python -m fpmash_tpu_torch find ref.msw reads.fq``; ``paste``, ``info``,
``bounds``, ``generate`` and ``mapping`` run on the host.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from fpmash_tpu_torch.commands import (
        bounds_cmd,
        contain_cmd,
        dist_cmd,
        find_cmd,
        info_cmd,
        lyn2vec_cmd,
        paste_cmd,
        screen_cmd,
        sketch_cmd,
        taxscreen_cmd,
        triangle_cmd,
    )

    parser = argparse.ArgumentParser(
        prog="fpmash",
        description="fpmash — Lyndon-fingerprint MinHash sketching and distance "
        "estimation on PyTorch + CUDA.",
    )
    sub = parser.add_subparsers(dest="command", metavar="<command>")
    sketch_cmd.add_parser(sub)
    dist_cmd.add_parser(sub)
    triangle_cmd.add_parser(sub)
    screen_cmd.add_parser(sub)
    taxscreen_cmd.add_parser(sub)
    contain_cmd.add_parser(sub)
    paste_cmd.add_parser(sub)
    info_cmd.add_parser(sub)
    bounds_cmd.add_parser(sub)
    find_cmd.add_parser(sub)
    lyn2vec_cmd.add_parsers(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 0
    from fpmash_tpu_torch.utils.trace import trace

    with trace(f"command:{args.command}"):
        return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
