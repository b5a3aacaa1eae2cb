"""Canonical k-mer hashes of a byte stream: kernels K7/K8, K6 and K5, their plain versions.

Three entry points over one ``uint8`` sequence (``csrc/kmer_hash.cu``; the
Pallas kernels they replace are named there).  Each returns the hash h1 of
the canonical k-mer starting at every position as two ``int32`` planes
holding the u32 bits of its low and high words (torch on the CPU has no
``uint32`` shifts); :func:`join_planes` makes the ``int64`` hash.

* :func:`kmer_hashes_planes` — ``(lo, hi, valid)`` of every position,
  unmasked; ``valid`` is true where the window's ``k`` bytes lie in the
  sequence and are all A, C, G or T (after case folding).  ``k <= 16``
  launches the K8 instance of the kernel, ``16 < k <= 32`` the K7 one.
* :func:`kmer_hashes_masked_planes` (K6) — the same planes with every lane
  that is invalid, starts after ``length - k`` or has ``hi > t_hi`` set to
  ``0xFFFFFFFF`` on both planes.  ``16 < k <= 32``.
* :func:`kmer_hashes_topk8_planes` (K5) — of each group of 128 consecutive
  positions (group ``g`` holds positions ``128 g .. 128 g + 127``), the 8
  smallest survivors of K6's mask by ``(hi, lo)``, ascending, duplicates
  kept, padded with ``0xFFFFFFFF``, in slots ``8 g .. 8 g + 7``: planes of
  ``8 ceil(N / 128)``; and ``overflow`` (a 0-dim bool tensor), true iff some
  group had more than 8 survivors.  The groups are the port's own: the TPU
  kernel grouped lane-strided positions, so the two agree as multisets of
  survivors when neither overflows.  ``16 < k <= 32``.

A survivor equal to the pad pair counts as a pad.  A wrapper runs the plain
version for a tensor on the CPU and launches the kernel for one on a CUDA
device.  The plain versions build on the packed formulation of
``ops/kmers.py``.  ``LAUNCHES`` counts the kernels' launches by name.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.kmers import _kmer_hashes_acgt
from fpmash_tpu_torch.ops.murmur3 import _SIGN

#: kernel launches in this process (the plain versions do not count)
LAUNCHES = {"planes_k16": 0, "planes_k32": 0, "masked": 0, "topk8": 0}

GROUP = 128
KEEP = 8
_PAD32 = 0xFFFFFFFF


def join_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The ``int64`` hash of ``int32`` low and high planes."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _PAD32)


def split_planes(h: torch.Tensor):
    """``(lo, hi)`` ``int32`` planes of an ``int64`` hash."""
    def low32(x):
        return (((x & _PAD32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)

    return low32(h), low32(h >> 32)


def _check(seq, k: int, length: int | None = None, t_hi: int | None = None, wide=False):
    if seq.dim() != 1 or seq.dtype != torch.uint8 or not seq.is_contiguous():
        raise ValueError(f"seq must be contiguous uint8 [N], got {seq.dtype} {tuple(seq.shape)}")
    if wide and not 16 < k <= 32:
        raise ValueError(f"this kernel takes 16 < k <= 32, got k={k}")
    if not 1 <= k <= 32:
        raise ValueError(f"the hash kernels take 1 <= k <= 32, got k={k}")
    if length is not None and not 0 <= length <= seq.numel():
        raise ValueError(f"length {length} is outside [0, {seq.numel()}]")
    if t_hi is not None and not 0 <= t_hi <= _PAD32:
        raise ValueError(f"t_hi must be a u32, got {t_hi}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the k-mer hash kernels run on cpu or cuda tensors, not {seq.device}")


def _flags(noncanonical: bool, preserve_case: bool) -> int:
    return int(noncanonical) | (int(preserve_case) << 1)


def _launch(name: str, fn, *args):
    from fpmash_tpu_torch.ops._build import check, library

    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        code = getattr(library(), fn)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    check(code, f"{fn} launch")
    LAUNCHES[name] += 1


def kmer_hashes_planes(seq: torch.Tensor, *, k: int, noncanonical: bool = False,
                       preserve_case: bool = False, seed: int = 42):
    """``(lo int32[N], hi int32[N], valid bool[N])`` of every position."""
    _check(seq, k)
    if seq.device.type == "cpu":
        return kmer_hashes_planes_plain(seq, k=k, noncanonical=noncanonical,
                                        preserve_case=preserve_case, seed=seed)
    N = seq.numel()
    lo = torch.empty(N, dtype=torch.int32, device=seq.device)
    hi = torch.empty_like(lo)
    valid = torch.empty(N, dtype=torch.bool, device=seq.device)
    if N:
        _launch("planes_k16" if k <= 16 else "planes_k32", "fpmash_kmer_hashes", seq, N, k,
                _flags(noncanonical, preserve_case), seed & ((1 << 64) - 1), lo, hi, valid)
    return lo, hi, valid


def kmer_hashes_masked_planes(seq: torch.Tensor, t_hi: int, length: int, *, k: int,
                              noncanonical: bool = False, preserve_case: bool = False,
                              seed: int = 42):
    """``(lo int32[N], hi int32[N])`` with dropped lanes set to the pad."""
    _check(seq, k, length, t_hi, wide=True)
    if seq.device.type == "cpu":
        return kmer_hashes_masked_planes_plain(seq, t_hi, length, k=k, noncanonical=noncanonical,
                                               preserve_case=preserve_case, seed=seed)
    N = seq.numel()
    lo = torch.empty(N, dtype=torch.int32, device=seq.device)
    hi = torch.empty_like(lo)
    if N:
        _launch("masked", "fpmash_kmer_hashes_masked", seq, N, length, k,
                _flags(noncanonical, preserve_case), seed & ((1 << 64) - 1), t_hi, lo, hi)
    return lo, hi


def kmer_hashes_topk8_planes(seq: torch.Tensor, t_hi: int, length: int, *, k: int,
                             noncanonical: bool = False, preserve_case: bool = False,
                             seed: int = 42):
    """``(clo int32[8G], chi int32[8G], overflow bool[])`` for the
    ``G = ceil(N / 128)`` groups of 128 positions."""
    _check(seq, k, length, t_hi, wide=True)
    if seq.device.type == "cpu":
        return kmer_hashes_topk8_planes_plain(seq, t_hi, length, k=k, noncanonical=noncanonical,
                                              preserve_case=preserve_case, seed=seed)
    N = seq.numel()
    slots = KEEP * (-(-N // GROUP))
    clo = torch.empty(slots, dtype=torch.int32, device=seq.device)
    chi = torch.empty_like(clo)
    overflow = torch.zeros(1, dtype=torch.int32, device=seq.device)
    if N:
        _launch("topk8", "fpmash_kmer_hashes_topk8", seq, N, length, k,
                _flags(noncanonical, preserve_case), seed & ((1 << 64) - 1), t_hi,
                clo, chi, overflow)
    return clo, chi, overflow[0] != 0


def kmer_hashes_planes_plain(seq: torch.Tensor, *, k: int, noncanonical: bool = False,
                             preserve_case: bool = False, seed: int = 42):
    """Plain version of :func:`kmer_hashes_planes`, on any device."""
    _check(seq, k)
    h, valid = _kmer_hashes_acgt(seq, seq.numel(), k=k, noncanonical=noncanonical,
                                 preserve_case=preserve_case, seed=seed)
    return (*split_planes(h), valid)


def _masked_hashes(seq, t_hi, length, *, k, noncanonical, preserve_case, seed):
    """``int64`` hashes of K6's mask: dropped lanes hold ``-1`` (the pad pair)."""
    h, valid = _kmer_hashes_acgt(seq, length, k=k, noncanonical=noncanonical,
                                 preserve_case=preserve_case, seed=seed)
    keep = valid & (((h >> 32) & _PAD32) <= t_hi)
    return torch.where(keep, h, -1)


def kmer_hashes_masked_planes_plain(seq: torch.Tensor, t_hi: int, length: int, *, k: int,
                                    noncanonical: bool = False, preserve_case: bool = False,
                                    seed: int = 42):
    """Plain version of :func:`kmer_hashes_masked_planes`, on any device."""
    _check(seq, k, length, t_hi, wide=True)
    return split_planes(_masked_hashes(seq, t_hi, length, k=k, noncanonical=noncanonical,
                                       preserve_case=preserve_case, seed=seed))


def kmer_hashes_topk8_planes_plain(seq: torch.Tensor, t_hi: int, length: int, *, k: int,
                                   noncanonical: bool = False, preserve_case: bool = False,
                                   seed: int = 42):
    """Plain version of :func:`kmer_hashes_topk8_planes`, on any device: the
    masked hashes in rows of 128, each sorted as unsigned, first 8 kept."""
    _check(seq, k, length, t_hi, wide=True)
    h = _masked_hashes(seq, t_hi, length, k=k, noncanonical=noncanonical,
                       preserve_case=preserve_case, seed=seed)
    rows = torch.nn.functional.pad(h, (0, (-h.numel()) % GROUP), value=-1).view(-1, GROUP)
    kept = (torch.sort(rows ^ _SIGN, dim=1).values[:, :KEEP] ^ _SIGN).reshape(-1)
    overflow = ((rows != -1).sum(dim=1) > KEEP).any()
    return (*split_planes(kept), overflow)
