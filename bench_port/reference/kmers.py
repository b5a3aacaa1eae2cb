"""Mash's classic sketch in plain PyTorch: canonical k-mers, MurmurHash3,
bottom-s of the distinct hashes, with counts and ``-m`` for read sets.

Mash (Ondov et al. 2016; ``Sketch.cpp`` addMinHashes): letters are upper-cased,
a window of ``k`` letters holding anything but A, C, G, T is skipped, the
canonical window is the smaller of the window and its reverse complement
compared as bytes, and its hash is ``h1`` of MurmurHash3_x64_128 over its
``k`` ASCII bytes (64 bits where 4^k > 2^32).  A genome's sketch is the
``s`` smallest distinct hashes; a read set's (``-r -m c``) the ``s``
smallest among the hashes seen at least ``c`` times, each with its count.
"""

from __future__ import annotations

import torch

from bench_port.reference.murmur3 import murmur3_h1, unsigned

_SIGN = -(1 << 63)


def _codes_table(device) -> torch.Tensor:
    table = torch.full((256,), 4, dtype=torch.int64, device=device)
    for v, ch in enumerate(b"ACGT"):
        table[ch] = v
        table[ch + 32] = v  # lower case folds to upper
    return table


def _complement_table(device) -> torch.Tensor:
    table = torch.arange(256, dtype=torch.int64, device=device)
    for a, b in (b"AT", b"TA", b"CG", b"GC"):
        table[a] = b
    return table


def _words(rows: torch.Tensor, n: int, first: int, count: int) -> torch.Tensor:
    """Little-endian 64-bit words of bytes ``first .. first + count - 1`` of
    each window ``rows[:, p : p + k]``, for the ``n`` window starts ``p``."""
    w = torch.zeros(rows.shape[0], n, dtype=torch.int64, device=rows.device)
    for b in range(count):
        w |= rows[:, first + b : first + b + n] << (8 * b)
    return w


def kmer_hashes(rows: torch.Tensor, k: int, seed: int):
    """``(hashes int64[R, n], valid bool[R, n])`` of every window of ``k``
    letters of each row of ``rows`` (``uint8[R, L]``, ``n = L - k + 1``)."""
    rows = rows.to(torch.int64)
    up = torch.where((rows > 96) & (rows < 123), rows - 32, rows)
    codes = _codes_table(rows.device)[up]
    R, L = up.shape
    n = L - k + 1
    bad = (codes == 4).to(torch.int64)
    run = torch.cat([torch.zeros(R, 1, dtype=torch.int64, device=up.device),
                     bad.cumsum(1)], 1)
    valid = (run[:, k:] - run[:, :n]) == 0
    # forward and reverse-complement windows as 2-bit big-endian numbers (in
    # int64, k <= 31 keeps them non-negative); A < C < G < T as bytes too
    fwd = torch.zeros(R, n, dtype=torch.int64, device=up.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j : j + n] & 3
        fwd = (fwd << 2) | c
        rev = rev | ((3 - c) << (2 * j))
    use_rc = rev < fwd
    rc = torch.flip(_complement_table(up.device)[up], [1])
    nwords = (k + 7) // 8
    words = []
    for i in range(nwords):
        count = min(8, k - 8 * i)
        f = _words(up, n, 8 * i, count)
        r = torch.flip(_words(rc, n, 8 * i, count), [1])
        words.append(torch.where(use_rc, r, f))
    h = murmur3_h1([w.reshape(-1) for w in words], k, seed).reshape(R, n)
    return h, valid


def _order_key(h: torch.Tensor) -> torch.Tensor:
    """Signed keys that sort as the unsigned hashes do."""
    return h ^ _SIGN


def distinct_counts(h: torch.Tensor, valid: torch.Tensor, use64: bool):
    """Distinct valid hashes in unsigned order (low 32 bits unless ``use64``)
    as signed order keys, and the number of times each occurs."""
    h = h[valid]
    if not use64:
        h = h & 0xFFFFFFFF
    return torch.unique(_order_key(h), sorted=True, return_counts=True)


def merge_counts(parts):
    """Unite ``(keys, counts)`` parts, adding the counts of equal keys."""
    keys = torch.cat([k for k, _ in parts])
    counts = torch.cat([c for _, c in parts])
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    total = torch.zeros(len(uniq), dtype=counts.dtype, device=counts.device)
    total.index_add_(0, inverse, counts)
    return uniq, total


def bottom_s(keys: torch.Tensor, counts: torch.Tensor, s: int, min_copies: int = 1):
    """The ``s`` smallest hashes seen at least ``min_copies`` times, as
    unsigned Python ints, and their counts."""
    keep = counts >= min_copies
    keys, counts = keys[keep][:s], counts[keep][:s]
    return [unsigned(int(v) ^ _SIGN) for v in keys.cpu().tolist()], counts.cpu().tolist()


def sketch_rows(rows: torch.Tensor, k: int, seed: int, use64: bool = True,
                block: int = 1 << 22):
    """``(keys, counts)`` of every distinct hash of the windows of ``rows``
    (``uint8[R, L]``; a read's windows never cross into the next read), in
    order, with how often each occurs; hashed in blocks of about ``block``
    windows."""
    R, L = rows.shape
    per = max(1, block // max(1, L - k + 1))
    parts = []
    for r0 in range(0, R, per):
        h, valid = kmer_hashes(rows[r0 : r0 + per], k, seed)
        parts.append(distinct_counts(h, valid, use64))
    return merge_counts(parts) if len(parts) > 1 else parts[0]


def genome_sketch(seq: torch.Tensor, k: int, s: int, seed: int, use64: bool = True,
                  block: int = 1 << 22):
    """Bottom-``s`` hashes (unsigned ints) of one sequence ``uint8[N]``,
    hashed in overlapping blocks of ``block`` windows."""
    n = seq.numel() - k + 1
    parts = []
    for p in range(0, max(n, 0), block):
        piece = seq[p : min(p + block, n) + k - 1]
        h, valid = kmer_hashes(piece[None, :], k, seed)
        keys, counts = distinct_counts(h, valid, use64)
        parts.append((keys[: s], counts[: s]))
    if not parts:
        return [], []
    keys, counts = merge_counts(parts) if len(parts) > 1 else parts[0]
    return bottom_s(keys, counts, s)


def set_size_estimate(values: list[int], s: int, bits: int) -> int:
    """Mash's cardinality estimate of a read set, its sketch's ``length``
    (MinHashHeap.h: ``2^bits * s / topHash``), or the number of hashes kept
    where fewer than ``s`` were."""
    if len(values) < s or values[s - 1] == 0:
        return len(values)
    return int((2.0 ** bits) * s / float(values[s - 1]))
