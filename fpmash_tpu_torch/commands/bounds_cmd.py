"""`bounds` — Mash error-bound table (CommandBounds.cpp:85-190).

For each sketch size s and true distance d, finds the smallest x with
``binom_cdf(x, s, m2j) > (1-prob)/2`` and prints the resulting distance
error ``j2m(x/s) - d`` for both the Mash and Screen distance models."""

from __future__ import annotations

import math
import sys

from fpmash_tpu_torch.scalar.stats import binom_cdf, format_g


def add_parser(sub):
    p = sub.add_parser("bounds", help="Print a table of Mash error bounds.")
    p.add_argument("-k", "--kmer", type=int, default=21, help="k-mer size. [21]")
    p.add_argument("-p", "--prob", type=float, default=0.99, help="Mash distance estimates will be within the given error bounds with this probability. [0.99]")
    p.set_defaults(func=run)
    return p


SKETCH_SIZES = [100, 500, 1000, 5000, 10000, 50000, 100000, 500000, 1000000]
DISTS = [0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4]


def _smallest_x_exceeding(s: int, p: float, q2: float) -> int:
    """Smallest x in [0, s] with binom_cdf(x, s, p) > q2 — the reference's
    linear scan (CommandBounds.cpp:148-160), seeded by the quantile
    function to stay O(1) even at s=1e6."""
    from scipy.stats import binom

    x = int(binom.ppf(q2, s, p))
    x = max(0, x - 2)
    while x < s and not (binom_cdf(x, s, p) > q2):
        x += 1
    return x


def run(args) -> int:
    k = args.kmer
    q2 = (1.0 - args.prob) / 2.0
    out = sys.stdout
    out.write("\nParameters (run with -h for details):\n")
    out.write(f"   k:   {k}\n")
    out.write(f"   p:   {format_g(args.prob)}\n\n")

    for cont in (False, True):
        out.write("\tScreen distance\n" if cont else "\tMash distance\n")
        out.write("Sketch")
        for d in DISTS:
            out.write(f"\t{format_g(d)}")
        out.write("\n")
        for s in SKETCH_SIZES:
            out.write(str(s))
            for d in DISTS:
                if cont:
                    m2j = (1.0 - d) ** k  # binomial model
                else:
                    m2j = 1.0 / (2.0 * math.exp(k * d) - 1.0)
                x = _smallest_x_exceeding(s, m2j, q2)
                je = x / s
                if cont:
                    j2m = 1.0 - je ** (1.0 / k)
                else:
                    j2m = -1.0 / k * math.log(2.0 * je / (1.0 + je)) if je > 0 else 1.0
                out.write(f"\t{format_g(j2m - d)}")
            out.write("\n")
        out.write("\n")
    return 0
