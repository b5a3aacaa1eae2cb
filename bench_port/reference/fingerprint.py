"""fp-mash's fingerprint sketch (``sketch --direct-fp``), in plain PyTorch.

fp-mash (UmbertoDellaMonica/fp-mash, README.md:27-104; lyn2vec
``fingerprint_utils.py``): each read of at least 100 letters gives one word a
letter, its cyclic window of 100 (a shorter read gives itself); each word is
factorized (CFL, ICFL_COMB, ...), and the vector of its factor lengths, as
unsigned 64-bit integers, is hashed with MurmurHash3_x64_128, seed 42, whose
``h1`` keeps its low 32 bits.  A read becomes one sketch entry named by the
FASTA header's second token (or its first) with ``_0`` appended, holding its
windows' hashes in order, unsorted; its ``length`` counts every window's
factors, the first window's twice (Mash's ``Sketch.cpp`` counts the first line
of a reference twice).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bench_port.reference.lyndon import factor_marks
from bench_port.reference.murmur3 import murmur3_h1, unsigned

WINDOW = 100
#: fingerprint lines a sketch holds at most (Sketch.cpp); not modelled here
LINE_CAP = 1_000_000


def window_count(seqs) -> int:
    return sum(len(s) if len(s) >= WINDOW else 1 for s in seqs)


@dataclass
class FpEntry:
    name: str
    comment: str
    length: int
    hashes: list
    factors: int  # factor lengths hashed over all its windows


def windows(reads: torch.Tensor, lengths: list[int]):
    """``(words uint8[B, W], word_lengths int64[B], per_read list)`` of the
    reads ``reads[r, :lengths[r]]``: every cyclic window of ``WINDOW``
    letters of a read at least that long, else the read itself."""
    dev = reads.device
    rows, cols, wl, per = [], [], [], []
    for r, n in enumerate(lengths):
        if n >= WINDOW:
            start = torch.arange(n, device=dev)
            pos = (start[:, None] + torch.arange(WINDOW, device=dev)[None, :]) % n
            rows.append(torch.full((n,), r, device=dev))
            cols.append(pos)
            wl.append(torch.full((n,), WINDOW, device=dev))
            per.append(n)
        else:
            pos = torch.arange(WINDOW, device=dev)[None, :].clamp(max=max(n - 1, 0))
            rows.append(torch.full((1,), r, device=dev))
            cols.append(pos)
            wl.append(torch.full((1,), n, device=dev))
            per.append(1)
    rows, cols, wl = torch.cat(rows), torch.cat(cols), torch.cat(wl)
    words = reads[rows[:, None], cols]
    words = torch.where(torch.arange(WINDOW, device=dev)[None, :] < wl[:, None], words, 0)
    return words, wl.to(torch.int64), per


def lengths_from_marks(marks: torch.Tensor, n: torch.Tensor):
    """``(factor lengths int64[B, C], counts int64[B])``: the gaps between a
    word's factor starts, the last one up to its length, left-aligned."""
    B, W = marks.shape
    pos = torch.arange(W, device=marks.device)[None, :].expand(B, W)
    stop = torch.where(marks, pos, n[:, None].expand(B, W))
    after = torch.cat([stop[:, 1:], n[:, None]], 1)
    nxt = torch.flip(torch.cummin(torch.flip(after, [1]), 1).values, [1])
    flen = torch.where(marks, nxt - pos, 0)
    counts = marks.sum(1)
    C = int(counts.max()) if B else 0
    rank = marks.long().cumsum(1) - 1
    out = torch.zeros(B, C + 1, dtype=torch.int64, device=marks.device)
    out.scatter_(1, torch.where(marks, rank, C), flen)
    return out[:, :C], counts


def vector_hashes(vecs: torch.Tensor, counts: torch.Tensor, seed: int,
                  element_bytes: int = 8) -> torch.Tensor:
    """``h1`` of each row's first ``counts[b]`` values as little-endian
    unsigned integers of ``element_bytes`` bytes (fp-mash hashes 8)."""
    B, C = vecs.shape
    if element_bytes == 4:  # two values a word
        pad = torch.zeros(B, C % 2, dtype=vecs.dtype, device=vecs.device)
        v = torch.cat([vecs, pad], 1).reshape(B, -1, 2)
        words = v[:, :, 0] | (v[:, :, 1] << 32)
    else:
        words = vecs
    cols = [words[:, c] for c in range(words.shape[1])] or [torch.zeros_like(counts)]
    return murmur3_h1(cols, counts * element_bytes, seed)


def fp_sketch(records, family: str, device, seed: int = 42, bits: int = 32,
              block: int = 1 << 21, element_bytes: int = 8) -> list[FpEntry]:
    """The sketch entries of ``records`` (``(header, sequence)`` pairs), for
    ``sketch --direct-fp --factorization family`` with ``--rev-comb true``."""
    entries = []
    seqs = [s.upper() for _, s in records]
    hashes_all, counts_all, per_all = [], [], []
    # reads in groups of about ``block`` windows
    group, size = [], 0
    for i, s in enumerate(seqs + [None]):
        if s is not None:
            group.append(s)
            size += max(len(s), 1)
        if group and (s is None or size >= block):
            width = max(len(g) for g in group)
            buf = torch.zeros(len(group), max(width, 1), dtype=torch.uint8)
            for r, g in enumerate(group):
                buf[r, : len(g)] = torch.frombuffer(bytearray(g.encode("ascii")), dtype=torch.uint8)
            words, wl, per = windows(buf.to(device), [len(g) for g in group])
            marks = factor_marks(family, words, wl)
            vecs, counts = lengths_from_marks(marks, wl)
            h = vector_hashes(vecs, counts, seed, element_bytes)
            if bits == 32:
                h = h & 0xFFFFFFFF
            hashes_all.append(h.cpu())
            counts_all.append(counts.cpu())
            per_all.extend(per)
            group, size = [], 0
    hashes = torch.cat(hashes_all).tolist() if hashes_all else []
    counts = torch.cat(counts_all).tolist() if counts_all else []
    pos = 0
    for (header, _), n in zip(records, per_all):
        name, _, comment = header.partition(" ")
        rid = (comment.split() or [name])[0] + "_0"
        cs = counts[pos : pos + n]
        entries.append(FpEntry(name=rid, comment=f"FingerPrint : {rid}",
                               length=sum(cs) + cs[0],
                               hashes=[unsigned(h) for h in hashes[pos : pos + n]],
                               factors=sum(cs)))
        pos += n
    return entries
