"""Mash's ``screen`` in plain PyTorch: the containment of each reference
sketch in a read set, streaming semantics (CommandScreen.cpp).

Every k-mer of the reads is hashed as ``reference/kmers.py`` hashes it
(canonical, MurmurHash3 ``h1``; the low 32 bits where 32-bit hashes are
asked for), and the read set's distinct hashes are counted.  A reference
shares the hashes of its sketch that the reads hold; with ``-w`` each such
hash goes to one reference alone, the one with the best identity before the
reallocation, then the greatest length, then the lowest index.  A line
reports a reference that shares any: identity ``(shared / denom)^(1/k)``
(``denom`` its sketch's size), ``shared/denom``, the median multiplicity of
its shared hashes (the ``shared // 2``-th in ascending order), the p-value
``pValueWithin``, ``P(X >= shared)`` for ``X ~ B(denom, r)``, ``r =
setSize / 4^k`` clamped to 1, where ``setSize`` is Mash's estimate from the
read set's ``s``-th smallest distinct hash, ``2^bits s / h``, truncated;
then the name and comment.  ``-i`` keeps lines of at least that identity,
``-v`` those of at most that p-value.

Hashes stay in tensors as signed order keys (the unsigned value less
``2^63``), so signed order is unsigned order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bench_port.checks.dist_lines import binom_tail
from bench_port.reference import kmers as ref_kmers

_SIGN = -(1 << 63)


@dataclass
class Database:
    """A sketch database: each reference's hashes as keys, back to back
    (``keys[sum(seg_len[:i]) :][: seg_len[i]]``), its length, name and comment."""

    keys: torch.Tensor
    seg_len: torch.Tensor
    lengths: torch.Tensor
    names: list
    comments: list


@dataclass
class Query:
    """A read set's distinct hashes as ascending keys, their multiplicities,
    and the width of its hashes."""

    keys: torch.Tensor
    counts: torch.Tensor
    bits: int


def database(hashes, seg_len, lengths, names, comments, bits: int, device) -> Database:
    """:class:`Database` of 64-bit ``hashes`` (numpy ``uint64``), their low
    ``bits`` bits kept."""
    h = torch.from_numpy(hashes.view("int64")).to(device)
    if bits < 64:
        h = h & ((1 << bits) - 1)
    return Database(h ^ _SIGN, torch.as_tensor(seg_len, device=device),
                    torch.as_tensor(lengths, device=device), list(names), list(comments))


def query(rows: torch.Tensor, k: int, seed: int, bits: int) -> Query:
    """:class:`Query` of reads ``uint8[R, L]``."""
    keys, counts = ref_kmers.sketch_rows(rows, k, seed, bits == 64)
    return Query(keys, counts, bits)


def set_size(q: Query, s: int) -> int:
    """Mash's estimate of the read set's distinct k-mers (MinHashHeap.h)."""
    if q.keys.numel() < s:
        return q.keys.numel()
    v = q.keys[s - 1] ^ _SIGN  # the u64 bits
    top = float((v >> 32) & 0xFFFFFFFF) * 2.0**32 + float(v & 0xFFFFFFFF)
    return int((2.0**q.bits) * s / top) if top else q.keys.numel()


def identity(shared: torch.Tensor, denom: torch.Tensor, k: int) -> torch.Tensor:
    ratio = shared.double() / denom.double().clamp(min=1)
    out = torch.where(shared == denom, 1.0, ratio ** (1.0 / k))
    return torch.where((shared == 0) | (denom == 0), 0.0, out)


def screen(db: Database, q: Query, k: int, s: int, *, winner: bool = False,
           min_identity: float = 0.0, max_pvalue: float = 1.0) -> list[tuple]:
    """The lines of ``screen`` as ``(name, comment, shared, denom, median,
    identity, p-value)``, in database order."""
    dev = db.keys.device
    n_refs = db.seg_len.numel()
    ref_of = torch.repeat_interleave(torch.arange(n_refs, device=dev), db.seg_len)
    if q.keys.numel():
        at = torch.searchsorted(q.keys, db.keys).clamp(max=q.keys.numel() - 1)
        hit = q.keys[at] == db.keys
    else:
        at = torch.zeros(db.keys.numel(), dtype=torch.int64, device=dev)
        hit = torch.zeros(db.keys.numel(), dtype=torch.bool, device=dev)
    ref, rank = ref_of[hit], at[hit]
    mult = q.counts[rank]
    shared = torch.bincount(ref, minlength=n_refs)
    if winner:
        score = identity(shared, db.seg_len, k)[ref]
        length = db.lengths[ref]
        groups, g = torch.unique(rank, return_inverse=True)
        m = groups.numel()
        best = torch.full((m,), -1.0, dtype=score.dtype, device=dev)
        best = best.scatter_reduce(0, g, score, "amax")
        tied = score == best[g]
        longest = torch.full((m,), -1, dtype=length.dtype, device=dev)
        longest = longest.scatter_reduce(0, g[tied], length[tied], "amax")
        tied &= length == longest[g]
        first = torch.full((m,), n_refs, dtype=ref.dtype, device=dev)
        first = first.scatter_reduce(0, g[tied], ref[tied], "amin")
        keep = ref == first[g]
        ref, mult = ref[keep], mult[keep]
        shared = torch.bincount(ref, minlength=n_refs)
    # each reference's multiplicities, ascending, back to back
    order = torch.argsort(ref * (int(mult.max()) + 1 if mult.numel() else 1) + mult)
    mult_sorted = mult[order]
    starts = torch.cumsum(shared, 0) - shared
    shown = torch.arange(n_refs, device=dev) if min_identity < 0 else shared.nonzero().flatten()
    sh, denom = shared[shown], db.seg_len[shown]
    median = torch.zeros_like(sh)
    has = sh > 0
    median[has] = mult_sorted[starts[shown][has] + sh[has] // 2]
    ident = identity(sh, denom, k)
    r = min(max(set_size(q, s) / 4.0**k, 0.0), 1.0)
    pval = binom_tail(sh - 1, denom, torch.full(sh.shape, r, dtype=torch.float64, device=dev))
    pval = torch.where(sh == 0, 1.0, pval)
    keep = (ident >= min_identity) & (pval <= max_pvalue)
    out = []
    for i, c, d, md, ii, pv, kept in zip(shown.tolist(), sh.tolist(), denom.tolist(),
                                          median.tolist(), ident.tolist(), pval.tolist(),
                                          keep.tolist()):
        if kept:
            out.append((db.names[i], db.comments[i], c, d, md, ii, pv))
    return out
