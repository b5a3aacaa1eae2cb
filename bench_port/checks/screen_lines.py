"""The lines of ``screen`` (streaming semantics) of a sketch database
against a read set, against the plain reference's (``reference/screen.py``)
worked out from the step's two input groups: the first the database, the
second the read set.  The traffic's ``expect`` gives the options the step
runs with: ``winner`` (``-w``), ``identity`` (``-i``), ``pvalue`` (``-v``).

A line is ``identity  shared/denom  median  p-value  name  comment``.

* ``wrong_lines``: lines missing or extra (by name), or whose comment,
  ``shared``, ``denom`` or median differs, or whose identity or p-value is
  off by more than its printed six significant digits allow.  Limit 0.
"""

from bench_port.checks.dist_lines import REL_TOL
from bench_port.reference import screen as ref_screen

LIMITS = {"wrong_lines": 0}


def parse(data: bytes) -> list[tuple]:
    out = []
    for line in data.decode().splitlines():
        ident, frac, median, pval, name, comment = line.split("\t")[:6]
        shared, denom = frac.split("/")
        out.append((name, comment, int(shared), int(denom), int(median), float(ident),
                    float(pval)))
    return out


def expected(reference, groups) -> list[tuple]:
    (db,) = reference.entries(groups[0][0])
    (q,) = reference.entries(groups[1][0])
    h, e = reference.header, reference.expect
    return ref_screen.screen(db, q, h["kmer"], h["sketch_size"], winner=e.get("winner", False),
                             min_identity=e.get("identity", 0.0), max_pvalue=e.get("pvalue", 1.0))


def render(want: list[tuple], reference) -> list[tuple]:
    return [(*w[:5], float(f"{w[5]:g}"), float(f"{w[6]:g}")) for w in want]


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= REL_TOL * abs(want) + 1e-300


def compare(got: list[tuple], want: list[tuple], reference) -> dict:
    by_name = {w[0]: w for w in want}
    wrong = len(want) - len({g[0] for g in got} & set(by_name))
    for g in got:
        w = by_name.get(g[0])
        wrong += w is None or g[1:5] != w[1:5] or not _close(g[5], w[5]) or not _close(g[6], w[6])
    return {"wrong_lines": wrong}
