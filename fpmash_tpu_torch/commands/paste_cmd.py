"""`paste` — merge sketch files (CommandPaste.cpp:25-242).

A host verb: flags, defaults and output bytes are those of ``python -m
fpmash_tpu paste``.

Quirks preserved: with ``-fp`` each ``.txt`` operand must have a sibling
pre-sketched ``.msh`` (extension-swapped; error if missing), and each
``.msh`` operand must have a sibling ``.txt`` (CommandPaste.cpp:154-190);
``-o`` moves the output operand to the last position (default: first).
Refuses to overwrite an existing output.
"""

from __future__ import annotations

import os
import sys

from fpmash_tpu_torch.commands.common import split_file
from fpmash_tpu_torch.models.sketch import Sketch


def add_parser(sub):
    p = sub.add_parser("paste", help="Create a single sketch file from multiple sketch files.")
    p.add_argument("operands", nargs="+", metavar="<out_prefix> <sketch> ...")
    p.add_argument("-l", "--list", action="store_true", help="Input files are lists of file names.")
    p.add_argument("-fp", "--fingerprint", action="store_true", help="Operands are fingerprint .txt files (their sibling .msh sketches are pasted).")
    p.add_argument("-o", "--output", action="store_true", help="The output prefix is the LAST operand instead of the first.")
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    if args.list and args.fingerprint:
        print("ERROR: The options -l and -fp are incompatible.", file=sys.stderr)
        return 1
    ops = args.operands
    if len(ops) < 2:
        print("ERROR: paste needs an output prefix and at least one sketch.", file=sys.stderr)
        return 1
    if args.output:
        files, out = ops[:-1], ops[-1]
    else:
        out, files = ops[0], ops[1:]
    if args.list:
        expanded = []
        for f in files:
            expanded.extend(split_file(f))
        files = expanded

    good = []
    for f in files:
        if args.fingerprint:
            if not (f.endswith(".txt") or f.endswith(".msh")):
                print(f'ERROR: The file "{f}" does not look like a fingerprint or sketch.', file=sys.stderr)
                return 1
            if f.endswith(".txt"):
                msh = f[:-4] + ".msh"
                if not os.path.exists(msh):
                    print(
                        f'ERROR: The file "{msh}" does not exist but is required. '
                        "Do the command sketch before doing this operation ",
                        file=sys.stderr,
                    )
                    return 1
                f = msh
            else:
                txt = f[:-4] + ".txt"
                if not os.path.exists(txt):
                    print(f'ERROR: The file "{txt}" does not exist but is required.', file=sys.stderr)
                    return 1
        else:
            if not f.endswith(".msh"):
                print(f'ERROR: The file "{f}" does not look like a sketch.', file=sys.stderr)
                return 1
        good.append(f)

    sketch = Sketch()
    for f in good:
        sketch.load_msh(f)

    if not out.endswith(".msh"):
        out += ".msh"
    if os.path.exists(out):
        print(f'ERROR: "{out}" exists; remove to write.', file=sys.stderr)
        return 1
    print(f"Writing {out}...", file=sys.stderr)
    sketch.write_msh(out)
    return 0
