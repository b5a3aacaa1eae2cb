"""The lines of ``dist`` (``dist -fp``: fingerprint sketches) of two sketch
files, against Mash's distance (CommandDistance.cpp:365-450) worked out from
the reference's entries of the step's two input groups: the first group's
entries are the references, the second's the queries.

Each loaded hash list keeps its first ``sketch_size`` hashes in stored order
(Sketch.cpp:1117-1120); ``common`` and ``denom`` come from the literal
merge-join walk over those lists, capped at ``sketch_size``; the distance is
``-ln(2j / (1 + j)) / k`` of ``j = common / denom`` (0 where they are equal,
1 where ``common`` is 0, at most 1); the p-value is the binomial tail
``P(X >= common)``, ``X ~ B(denom, r)``, with ``r`` from both lengths and the
k-mer space (1 where ``common`` is 0).  A line is ``ref query distance
p-value common/denom``, queries outer, references inner, every pair (the
default ``-d 1 -v 1`` passes all).

* ``wrong_pairs``: lines missing, extra, or with a name, ``common`` or
  ``denom`` that differs, or a distance or p-value off by more than its
  printed six significant digits allow.  Limit 0.
"""

import math

import torch

LIMITS = {"wrong_pairs": 0}
#: a printed value holds six significant digits: half a unit of the sixth
#: is 5e-6 of it at most
REL_TOL = 1e-5
_SIGN = 1 << 63


def parse(data: bytes) -> list[tuple]:
    out = []
    for line in data.decode().splitlines():
        r, q, d, p, frac = line.split("\t")
        common, denom = frac.split("/")
        out.append((r, q, float(d), float(p), int(common), int(denom)))
    return out


def _lists(entries, cap: int):
    n = max([min(len(w.hashes), cap) for w in entries] + [1])
    out = torch.zeros(len(entries), n, dtype=torch.int64)
    lengths = torch.zeros(len(entries), dtype=torch.int64)
    for r, w in enumerate(entries):
        h = [v - _SIGN for v in w.hashes[:cap]]  # unsigned order as int64 order
        out[r, : len(h)] = torch.tensor(h, dtype=torch.int64)
        lengths[r] = len(h)
    return out, lengths


def walk(A, la, B, lb, s: int):
    """``(common, denom)`` ``[R, Q]`` of CommandDistance::compareSketches's
    walk over every pair of rows of ``A`` and ``B`` (their stored order)."""
    R, Q = len(la), len(lb)
    i = torch.zeros(R, Q, dtype=torch.int64, device=A.device)
    j = torch.zeros_like(i)
    common = torch.zeros_like(i)
    denom = torch.zeros_like(i)
    la2, lb2 = la[:, None].expand(R, Q), lb[None, :].expand(R, Q)
    for step in range(s):
        act = (denom < s) & (i < la2) & (j < lb2)
        if step % 64 == 0 and not bool(act.any()):
            break
        a = A.gather(1, i.clamp(max=A.shape[1] - 1))
        b = B.gather(1, j.clamp(max=B.shape[1] - 1).T).T
        lt, gt = a < b, b < a
        eq = ~lt & ~gt
        i += act & ~gt
        j += act & ~lt
        common += act & eq
        denom += act.long()
    short = denom < s
    denom = denom + torch.where(short, (la2 - i).clamp(min=0) + (lb2 - j).clamp(min=0), 0)
    denom = torch.where(short, denom.clamp(max=s), denom)
    return common, denom


def binom_tail(k, n, p):
    """``P(X > k)``, ``X ~ B(n, p)``, elementwise (float64), as GSL's
    ``gsl_cdf_binomial_Q(k, p, n)``: a sum of terms in log space."""
    out = torch.zeros_like(p)
    top = int(n.max()) if n.numel() else 0
    ints = torch.arange(top + 1, device=p.device)
    lfact = torch.lgamma(ints.double() + 1)  # ln(x!) for x = 0 .. top
    i = ints.double()
    for s in range(0, len(p), 2048):
        kk, nn, pp = k[s : s + 2048, None], n[s : s + 2048, None], p[s : s + 2048, None]
        logc = lfact[nn.clamp(min=0)] - lfact[ints] - lfact[(nn - ints).clamp(min=0)]
        terms = logc + i * torch.log(pp) + (nn - i) * torch.log1p(-pp)
        terms = torch.where((i > kk) & (i <= nn), terms, -math.inf)
        out[s : s + 2048] = torch.logsumexp(terms, 1).exp()
    out = torch.where(k >= n, 0.0, out)
    out = torch.where(k < 0, 1.0, out)
    out = torch.where(p >= 1, torch.where(k < n, 1.0, 0.0), out)
    return torch.where((n <= 0) | (p <= 0), 0.0, out)


def expected(reference, groups) -> list[tuple]:
    refs = [w for idx in groups[0] for w in reference.entries(idx)]
    qrys = [w for idx in groups[1] for w in reference.entries(idx)]
    h = reference.header
    s, k = h["sketch_size"], h["kmer"]
    space = float(len(h["alphabet"])) ** k
    dev = reference.device
    A, la = (t.to(dev) for t in _lists(refs, s))
    B, lb = (t.to(dev) for t in _lists(qrys, s))
    common, denom = walk(A, la, B, lb, s)
    c, d = common.reshape(-1), denom.reshape(-1)
    jac = c.double() / d.double()
    dist = (-torch.log(2 * jac / (1 + jac)) / k).clamp(max=1.0)
    dist = torch.where(c == 0, 1.0, dist)
    dist = torch.where(c == d, 0.0, dist)
    lref = torch.tensor([float(w.length) for w in refs], dtype=torch.float64, device=dev)
    lqry = torch.tensor([float(w.length) for w in qrys], dtype=torch.float64, device=dev)
    px = (1.0 / (1.0 + space / lref))[:, None].expand(len(refs), len(qrys)).reshape(-1)
    py = (1.0 / (1.0 + space / lqry))[None, :].expand(len(refs), len(qrys)).reshape(-1)
    r = px * py / (px + py - px * py)
    pval = torch.where(c == 0, 1.0, binom_tail(c - 1, d, r))
    shape = (len(refs), len(qrys))
    dist, pval = dist.reshape(shape).tolist(), pval.reshape(shape).tolist()
    common, denom = common.tolist(), denom.tolist()
    return [(refs[ri].name, q.name, dist[ri][qi], pval[ri][qi], common[ri][qi], denom[ri][qi])
            for qi, q in enumerate(qrys) for ri in range(len(refs))]


def render(want: list[tuple], reference) -> list[tuple]:
    return [(r, q, float(f"{d:g}"), float(f"{p:g}"), c, n) for r, q, d, p, c, n in want]


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= REL_TOL * abs(want) + 1e-300


def compare(got: list[tuple], want: list[tuple], reference) -> dict:
    wrong = abs(len(got) - len(want))
    for g, w in zip(got, want):
        wrong += (g[:2] != w[:2] or g[4:] != w[4:] or not _close(g[2], w[2])
                  or not _close(g[3], w[3]))
    return {"wrong_pairs": wrong}
