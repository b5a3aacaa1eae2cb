"""K-mer extraction, canonicalization and hashing: the classic sketch path.

Counterpart of :mod:`fpmash_tpu.ops.kmers` (the reference's per-k-mer loop
``addMinHashes``, Sketch.cpp:664-735): case folding, alphabet validity,
canonical strand selection (the smaller of the window and its reverse
complement, compared as bytes, Sketch.cpp:721-723) and MurmurHash3 h1 of the
chosen k bytes.  Hashes are ``int64`` tensors holding the u64 bits
(``ops/murmur3.py``).

* :func:`_kmer_hashes_acgt` is the packed formulation for the DNA alphabet
  and ``k <= 32``: each window is one 2-bit big-endian u64 ``F`` and its
  packed reverse complement ``R`` (:func:`_pack_windows`), so the canonical
  pick is one unsigned min, then the hash (:func:`_canonical_murmur`).  The
  two parts are the plain versions of the hash kernels in
  ``ops/kmers_cuda.py``.
* :func:`_kmer_hashes_generic` takes any alphabet and ``k`` by gathering
  ``[N, k]`` byte windows and hashing them with ``murmur3_bytes_batch``
  (the JAX package computes it in XLA, not Pallas).
* :func:`kmer_hashes` routes between them; :func:`classic_sketch_device`
  is one chunk's fused sketch (hash kernel, then bottom-k), choosing among
  kernels K5, K6 and K7/K8 with the JAX package's gates.
"""

from __future__ import annotations

import numpy as np
import torch

from fpmash_tpu_torch.ops.murmur3 import (
    _block_update,
    _finalize,
    _mix_k1,
    _mix_k2,
    murmur3_bytes_batch,
    to_signed,
    ult,
)

# IUPAC complement for A-Z, identity elsewhere (Sketch.cpp:1223-1258).
_IUPAC = {
    "A": "T", "B": "V", "C": "G", "D": "H", "G": "C", "H": "D", "K": "M",
    "M": "K", "N": "N", "R": "Y", "S": "S", "T": "A", "U": "A", "V": "B",
    "W": "W", "Y": "R",
}

#: 2-bit code of each byte: A C G T -> 0 1 2 3, anything else 4 (invalid)
_CODES = np.full(256, 4, np.int64)
for _v, _ch in enumerate(b"ACGT"):
    _CODES[_ch] = _v


def complement_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint8)
    for a, b in _IUPAC.items():
        table[ord(a)] = ord(b)
        table[ord(a.lower())] = ord(b.lower())
    return table


def alphabet_mask(alphabet: str) -> np.ndarray:
    mask = np.zeros(256, dtype=bool)
    for c in alphabet:
        mask[ord(c)] = True
    return mask


def encode_seq(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8).copy()


def _check_seq(seq: torch.Tensor) -> None:
    if seq.dim() != 1 or seq.dtype != torch.uint8 or not seq.is_contiguous():
        raise ValueError(f"seq must be contiguous uint8 [N], got {seq.dtype} {tuple(seq.shape)}")


def _fold_case(seq: torch.Tensor, preserve_case: bool) -> torch.Tensor:
    """Lowercase a-z to uppercase unless ``preserve_case`` (Sketch.cpp:676-682)."""
    if preserve_case:
        return seq
    lower = (seq > 96) & (seq < 123)
    return torch.where(lower, seq - 32, seq)


def _pack_windows(codes: torch.Tensor, n: int, k: int):
    """``(F int64[n], R int64[n], valid bool[n])`` of the windows of ``k``
    codes starting at ``0 .. n - 1`` of a code stream (``codes``, at least
    ``n + k - 1`` long; a code outside ``0 .. 3`` is invalid and packs as
    ``code & 3``): ``F`` the big-endian packed window, ``R`` the packed
    reverse complement (complement ``c ^ 3`` at bit ``2 j``), ``valid``
    whether all ``k`` codes are valid."""
    c = codes & 3
    ok = (codes >= 0) & (codes < 4)
    F = torch.zeros(n, dtype=torch.int64, device=codes.device)
    R = torch.zeros_like(F)
    valid = torch.ones(n, dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[j : j + n].to(torch.int64)
        F = (F << 2) | cj
        R = R | ((cj ^ 3) << (2 * j))
        valid &= ok[j : j + n]
    return F, R, valid


def _canonical_murmur(F: torch.Tensor, R: torch.Tensor, k: int, noncanonical: bool = False,
                      seed: int = 42) -> torch.Tensor:
    """h1 (``int64``) of the canonical pick of packed windows ``F`` and ``R``:
    ``R`` only where ``R < F`` as unsigned 64-bit values (``R`` is not read
    when ``noncanonical``); the ASCII bytes ``65 + 2d + 2(d >> 1) + 11(d & d
    >> 1)`` of the code ``d`` at bit ``2 (k - 1 - j)``, so only bits ``[0, 2k)``
    count, in little-endian words; then MurmurHash3_x64_128 over ``k`` bytes."""
    P = F if noncanonical else torch.where(ult(R, F), R, F)
    words = [torch.zeros_like(F) for _ in range(2 * (k // 16) + 2)]
    for j in range(k):
        d = (P >> (2 * (k - 1 - j))) & 3
        d1 = d >> 1
        b = 65 + 2 * d + 2 * d1 + 11 * (d & d1)
        words[j >> 3] = words[j >> 3] | (b << (8 * (j & 7)))

    h1 = torch.full_like(F, to_signed(seed))
    h2 = h1.clone()
    nblocks, tail = divmod(k, 16)
    for blk in range(nblocks):
        h1, h2 = _block_update(h1, h2, words[2 * blk], words[2 * blk + 1])
    if tail > 8:
        h2 = h2 ^ _mix_k2(words[2 * nblocks + 1])
    if tail > 0:
        h1 = h1 ^ _mix_k1(words[2 * nblocks])
    h1, _ = _finalize(h1, h2, k)
    return h1


def _kmer_hashes_acgt(
    seq: torch.Tensor,
    length: int,
    *,
    k: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
):
    """``(h1 int64[N], valid bool[N])`` for the DNA alphabet, ``k <= 32``.

    The packed formulation: code ``c`` (A<C<G<T, so integer order is byte
    order) of every position, packed by :func:`_pack_windows` and hashed by
    :func:`_canonical_murmur`.

    An invalid byte (not ACGT after case folding) packs as code 0, and
    positions past the end of ``seq`` as invalid bytes, so every window has
    a defined hash; ``valid`` marks windows of ``k`` valid bytes that start
    at or before ``length - k``.
    """
    _check_seq(seq)
    if not 1 <= k <= 32:
        raise ValueError(f"the packed formulation takes 1 <= k <= 32, got {k}")
    N = seq.numel()
    dev = seq.device
    codes = torch.from_numpy(_CODES).to(dev)[_fold_case(seq, preserve_case).long()]
    F, R, valid = _pack_windows(torch.nn.functional.pad(codes, (0, k - 1), value=4), N, k)
    h1 = _canonical_murmur(F, R, k, noncanonical, seed)
    pos = torch.arange(N, device=dev)
    return h1, valid & (pos <= length - k)


def _kmer_hashes_generic(
    seq: torch.Tensor,
    length: int,
    *,
    alphabet: str = "ACGT",
    k: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
):
    """``(h1 int64[N], valid bool[N])`` for any alphabet and ``k``: the
    ``[N, k]`` byte windows, the reverse complement of the alphabet's
    characters and a byte-wise (``memcmp``) canonical pick, then
    :func:`murmur3_bytes_batch` over each window."""
    _check_seq(seq)
    N = seq.numel()
    dev = seq.device
    seq = _fold_case(seq, preserve_case)
    allowed = torch.from_numpy(alphabet_mask(alphabet)).to(dev)
    vchar = torch.nn.functional.pad(allowed[seq.long()], (0, k - 1), value=False)
    windows = torch.nn.functional.pad(seq, (0, k - 1)).unfold(0, k, 1)  # [N, k] view
    valid = vchar.unfold(0, k, 1).all(dim=1) & (torch.arange(N, device=dev) <= length - k)
    if not noncanonical:
        # only alphabet characters are complemented: windows with any other
        # character are invalid and never kept
        table = np.arange(256, dtype=np.uint8)
        ctab = complement_table()
        for ch in set(alphabet):
            table[ord(ch)] = ctab[ord(ch)]
        rc = torch.from_numpy(table).to(dev)[windows.long()].flip(1)
        differ = windows != rc
        first = differ.to(torch.uint8).argmax(dim=1, keepdim=True)
        take_rc = differ.any(dim=1) & (rc.gather(1, first) < windows.gather(1, first))[:, 0]
        windows = torch.where(take_rc[:, None], rc, windows)
    lengths = torch.full((N,), k, dtype=torch.int64, device=dev)
    h1, _ = murmur3_bytes_batch(windows.contiguous(), lengths, seed)
    return h1, valid


def kmer_hashes(
    seq: torch.Tensor,
    length: int,
    *,
    alphabet: str = "ACGT",
    k: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
):
    """Hash every k-mer of ``seq`` (``uint8[N]``, valid prefix ``length``).

    Returns ``(h1 int64[N], valid bool[N])``: entry ``i`` covers the window
    starting at ``i``; windows with a character outside the alphabet, or
    reaching past ``length``, are invalid (Sketch.cpp:696-713).  The full
    64-bit h1 is returned; a 32-bit sketch keeps its low half.

    The DNA alphabet with ``k <= 32`` goes through the hash kernels of
    ``ops/kmers_cuda.py`` (K7 for ``16 < k``, K8 below; their plain
    versions for a tensor on the CPU); any other alphabet or ``k`` through
    :func:`_kmer_hashes_generic`.
    """
    if set(alphabet) == set("ACGT") and k <= 32:
        from fpmash_tpu_torch.ops.kmers_cuda import join_planes, kmer_hashes_planes

        lo, hi, window_valid = kmer_hashes_planes(
            seq, k=k, noncanonical=noncanonical, preserve_case=preserve_case, seed=seed
        )
        pos = torch.arange(seq.numel(), device=seq.device)
        return join_planes(lo, hi), window_valid & (pos <= length - k)
    return _kmer_hashes_generic(
        seq, length, alphabet=alphabet, k=k, noncanonical=noncanonical,
        preserve_case=preserve_case, seed=seed,
    )


def chunk_threshold(N: int, k: int, s: int, boost: int = 1) -> tuple[int, bool]:
    """``(t_hi, saturated)`` of a chunk of ``N`` positions: the high-word
    threshold that keeps a fraction ``8 s boost / (N - k + 1)`` of the hash
    space, and whether that fraction reached the whole space."""
    frac_f = min(1.0, (8.0 * s * boost) / max(N - (k - 1), 1))
    sat = frac_f >= 1.0
    return (0xFFFFFFFF if sat else min(0xFFFFFFFF, int(frac_f * float(2**32)))), sat


def classic_sketch_device(
    seq: torch.Tensor,
    length: int,
    *,
    k: int,
    s: int,
    noncanonical: bool = False,
    preserve_case: bool = False,
    seed: int = 42,
    min_cov: int = 1,
    boost: int = 1,
    need_counts: bool | None = None,
    out_slots: int | None = None,
):
    """One chunk's classic sketch: bytes -> bottom-s MinHash on the device.

    Returns ``(values int64[s], counts int64[s], n, ok)`` with the contract
    of ``ops/bottomk.py`` (``out_slots`` given: the collect-all contract of
    :func:`~fpmash_tpu_torch.ops.bottomk.bottom_k_premasked_planes` with
    ``out_slots`` slots).  For ``16 < k <= 32`` the hash kernel applies the
    bottom-k threshold itself: K5 (top-8 of every 128 positions) when
    ``min_cov == 1``, the threshold is not saturated and the chunk has at
    least ``2048 s boost`` positions (then about one survivor in 256
    positions, so a group of 128 rarely holds more than 8); K6 (pre-masked
    planes) otherwise.  Other ``k`` hash with K7/K8 and threshold here.

    The threshold fraction is sized on the chunk's size ``N``, not on
    ``length``: a short sequence in a padded chunk collects fewer
    candidates, ``ok`` says so, and the caller raises ``boost``.
    """
    from fpmash_tpu_torch.ops.bottomk import (
        bottom_k_premasked_planes,
        bottom_k_threshold_planes,
    )
    from fpmash_tpu_torch.ops.kmers_cuda import (
        kmer_hashes_masked_planes,
        kmer_hashes_planes,
        kmer_hashes_topk8_planes,
    )

    N = seq.numel()
    if need_counts is None:
        need_counts = min_cov > 1
    kw = dict(k=k, noncanonical=noncanonical, preserve_case=preserve_case, seed=seed)
    if 16 < k <= 32:
        t_hi, sat = chunk_threshold(N, k, s, boost)
        if out_slots is not None:
            bk = dict(s=out_slots, min_cov=1, need_counts=True, collect_all=True)
        else:
            bk = dict(s=s, min_cov=min_cov, need_counts=need_counts)
        if min_cov == 1 and not sat and N >= 2048 * s * boost:
            clo, chi, overflow = kmer_hashes_topk8_planes(seq, t_hi, length, **kw)
            values, counts, n, ok = bottom_k_premasked_planes(clo, chi, sat, **bk)
            return values, counts, n, ok and not bool(overflow)
        mlo, mhi = kmer_hashes_masked_planes(seq, t_hi, length, **kw)
        return bottom_k_premasked_planes(mlo, mhi, sat, **bk)
    lo, hi, window_valid = kmer_hashes_planes(seq, **kw)
    valid = window_valid & (torch.arange(N, device=seq.device) <= length - k)
    return bottom_k_threshold_planes(
        lo, hi, valid, s=s, min_cov=min_cov, boost=boost, need_counts=need_counts
    )
