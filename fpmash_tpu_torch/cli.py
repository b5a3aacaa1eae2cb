"""`fpmash` on PyTorch + CUDA — the CLI of the ported verbs.

Run ``python -m fpmash_tpu_torch <command> ...``.  Ported so far: ``sketch``
(classic k-mer MinHash of FASTA/FASTQ, ``-fp`` and ``--direct-fp``; not
``-W``), ``dist``, ``triangle`` (Phylip, ``-E``, ``-fp``), ``screen``
(streaming, ``-w``, ``-s``, ``-fp``) and ``fingerprint``; flags and output
bytes match ``python -m fpmash_tpu``.  Every command takes ``--device``
(default ``cuda``, an error without a card; ``--device cpu`` runs the
kernels' plain PyTorch versions), for example
``python -m fpmash_tpu_torch triangle -E a.msh --device cpu`` or
``python -m fpmash_tpu_torch screen refs.msh reads.fq``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from fpmash_tpu_torch.commands import (
        dist_cmd,
        lyn2vec_cmd,
        screen_cmd,
        sketch_cmd,
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
    lyn2vec_cmd.add_parser(sub)
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
