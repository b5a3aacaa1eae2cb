"""Canonical k-mer hashes: kernels K5-K8, K10, K11 and K12, their plain versions.

Entry points over one ``uint8`` sequence, the classic sketch's (routed in
the JAX package; ``csrc/kmer_hash.cu``, where the Pallas kernels they
replace are named).  Each returns the hash h1 of the canonical k-mer
starting at every position as two ``int32`` planes holding the u32 bits of
its low and high words (torch on the CPU has no ``uint32`` shifts);
:func:`join_planes` makes the ``int64`` hash.

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
  survivors when neither overflows (K10 keeps the TPU's groups).
  ``16 < k <= 32``.

Entry points of the JAX package's older formulations, unrouted there, with
the same names and contracts.  They take ``int32`` codes (the u32 code
stream: A C G T -> 0-3, any code of 4 or more as unsigned is invalid and
packs as ``code & 3``) or packed windows:

* :func:`canonical_murmur` (K11, ``canonical_murmur_pallas``) — h1
  ``int64[N]`` of the canonical pick of given ``int64`` ``F`` and ``R``.
* :func:`kmer_hashes_fused` and :func:`kmer_hashes_fused_planes` (K12,
  ``kmer_hashes_fused_pallas[_planes]``) — ``(h1, valid)`` or ``(lo, hi,
  valid)`` of every position, ``1 <= k <= 32``.  As on the TPU, the stream
  is padded with code 4 to ``Np``, a multiple of :data:`BLOCK`, and a window
  running past ``Np`` reads the stream's start again (the last row's halo
  was the first row), so positions past ``N - k``, which the caller masks,
  equal the JAX package's too.
* :func:`kmer_hashes_packed_topk_planes` (K10) — K5's contract in the TPU
  kernel's own layout: group ``(c, j)`` (block ``c`` of :data:`BLOCK`
  positions, ``j < 128``) holds positions ``BLOCK c + ROW_BLOCK s + j +
  128 m`` (``s < 8``, ``m < 16``) and its rank ``i`` goes to slot
  ``1024 c + 128 i + j``: planes of ``Np / 16``, slot for slot the JAX
  package's.  ``16 < k <= 32``.

A survivor equal to the pad pair counts as a pad.  A wrapper runs the plain
version for a tensor on the CPU and launches the kernel for one on a CUDA
device.  The plain versions build on the packed formulation of
``ops/kmers.py``.  ``LAUNCHES`` counts the kernels' launches by name.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.kmers import _canonical_murmur, _kmer_hashes_acgt, _pack_windows
from fpmash_tpu_torch.ops.murmur3 import _SIGN

#: kernel launches in this process (the plain versions do not count)
LAUNCHES = {"planes_k16": 0, "planes_k32": 0, "masked": 0, "topk8": 0,
            "topk_groups": 0, "canonical_murmur": 0, "codes_planes": 0}

GROUP = 128
KEEP = 8
#: the TPU layout that K10 and K12 keep: rows of ROW_BLOCK positions in
#: blocks of GROUPS rows (``kmers_pallas.py``'s ROW_BLOCK at its production
#: value, and GROUPS); K10 has TOPK_WIDTH groups a block
ROW_BLOCK, GROUPS, TOPK_WIDTH = 2048, 8, 128
BLOCK = ROW_BLOCK * GROUPS
_PAD32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def join_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The ``int64`` hash of ``int32`` low and high planes."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _PAD32)


def split_planes(h: torch.Tensor):
    """``(lo, hi)`` ``int32`` planes of an ``int64`` hash."""
    def low32(x):
        return (((x & _PAD32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)

    return low32(h), low32(h >> 32)


def _check(seq, k: int, length: int | None = None, t_hi: int | None = None, wide=False,
           name="seq", dtype=torch.uint8):
    """Raise unless ``seq`` is a contiguous ``dtype [N]`` stream on the CPU or
    a card and ``k``, ``length`` and ``t_hi`` are in range."""
    if seq.dim() != 1 or seq.dtype != dtype or not seq.is_contiguous():
        raise ValueError(f"{name} must be contiguous {str(dtype)[6:]} [N], got {seq.dtype} "
                         f"{tuple(seq.shape)}")
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


def _check_codes(codes, k: int, length: int | None = None, t_hi: int | None = None,
                 wide=False):
    _check(codes, k, length, t_hi, wide, name="codes", dtype=torch.int32)


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


# ---------------------------------------------------------------------- #
# the JAX package's unrouted formulations: K11, K12, K10
# ---------------------------------------------------------------------- #


def _check_packed(F, R, k: int):
    _check(F, k, name="F", dtype=torch.int64)
    _check(R, k, name="R", dtype=torch.int64)
    if F.shape != R.shape or F.device != R.device:
        raise ValueError(f"F and R differ: {tuple(F.shape)} on {F.device}, "
                         f"{tuple(R.shape)} on {R.device}")


def canonical_murmur(F: torch.Tensor, R: torch.Tensor, *, k: int, noncanonical: bool = False,
                     seed: int = 42) -> torch.Tensor:
    """h1 ``int64[N]`` of the canonical pick of the packed windows ``F`` (big
    endian) and ``R`` (packed reverse complement), ``int64`` holding the u64
    bits: ``R`` where ``R < F`` as unsigned, only bits ``[0, 2k)`` read,
    ``R`` ignored when ``noncanonical``.  K11."""
    _check_packed(F, R, k)
    if F.device.type == "cpu":
        return canonical_murmur_plain(F, R, k=k, noncanonical=noncanonical, seed=seed)
    h1 = torch.empty_like(F)
    if F.numel():
        _launch("canonical_murmur", "fpmash_canonical_murmur", F, R, F.numel(), k,
                _flags(noncanonical, False), seed & _M64, h1)
    return h1


def canonical_murmur_plain(F: torch.Tensor, R: torch.Tensor, *, k: int,
                           noncanonical: bool = False, seed: int = 42) -> torch.Tensor:
    """Plain version of :func:`canonical_murmur`, on any device."""
    _check_packed(F, R, k)
    return _canonical_murmur(F, R, k, noncanonical, seed)


def kmer_hashes_fused_planes(codes: torch.Tensor, *, k: int, noncanonical: bool = False,
                             seed: int = 42):
    """``(lo int32[N], hi int32[N], valid bool[N])`` of every position of a
    code stream, with the TPU layout's wrap past ``Np``.  K12."""
    _check_codes(codes, k)
    if codes.device.type == "cpu":
        return kmer_hashes_fused_planes_plain(codes, k=k, noncanonical=noncanonical, seed=seed)
    N = codes.numel()
    lo = torch.empty(N, dtype=torch.int32, device=codes.device)
    hi = torch.empty_like(lo)
    valid = torch.empty(N, dtype=torch.bool, device=codes.device)
    if N:
        _launch("codes_planes", "fpmash_kmer_codes_hashes", codes, N, k,
                _flags(noncanonical, False), seed & _M64, lo, hi, valid)
    return lo, hi, valid


def kmer_hashes_fused(codes: torch.Tensor, *, k: int, noncanonical: bool = False,
                      seed: int = 42):
    """``(h1 int64[N], valid bool[N])``: :func:`kmer_hashes_fused_planes`
    joined.  K12."""
    lo, hi, valid = kmer_hashes_fused_planes(codes, k=k, noncanonical=noncanonical, seed=seed)
    return join_planes(lo, hi), valid


def _padded_block(n: int) -> int:
    """``Np``: ``n`` rounded up to whole blocks of the TPU layout."""
    return -(-n // BLOCK) * BLOCK


def kmer_hashes_fused_planes_plain(codes: torch.Tensor, *, k: int, noncanonical: bool = False,
                                   seed: int = 42):
    """Plain version of :func:`kmer_hashes_fused_planes`, on any device: the
    stream padded with code 4 to ``Np``, followed by its own first ``k - 1``
    codes."""
    _check_codes(codes, k)
    N = codes.numel()
    padded = torch.nn.functional.pad(codes, (0, _padded_block(N) - N), value=4)
    F, R, valid = _pack_windows(torch.cat([padded, padded[: k - 1]]), N, k)
    return (*split_planes(_canonical_murmur(F, R, k, noncanonical, seed)), valid)


def kmer_hashes_packed_topk_planes(codes: torch.Tensor, t_hi: int, length: int, *, k: int,
                                   noncanonical: bool = False, seed: int = 42):
    """``(clo int32[Np/16], chi int32[Np/16], overflow bool[])``: of each
    group of the TPU layout, the 8 smallest survivors of K6's mask by
    ``(hi, lo)``, ascending, duplicates kept, padded, slot for slot the JAX
    package's.  K10."""
    _check_codes(codes, k, length, t_hi, wide=True)
    if codes.device.type == "cpu":
        return kmer_hashes_packed_topk_planes_plain(codes, t_hi, length, k=k,
                                                    noncanonical=noncanonical, seed=seed)
    N = codes.numel()
    slots = _padded_block(N) // (GROUP // KEEP)
    clo = torch.empty(slots, dtype=torch.int32, device=codes.device)
    chi = torch.empty_like(clo)
    overflow = torch.zeros(1, dtype=torch.int32, device=codes.device)
    if N:
        _launch("topk_groups", "fpmash_kmer_codes_topk", codes, N, length, k,
                _flags(noncanonical, False), seed & _M64, t_hi, clo, chi, overflow)
    return clo, chi, overflow[0] != 0


def kmer_hashes_packed_topk_planes_plain(codes: torch.Tensor, t_hi: int, length: int, *, k: int,
                                         noncanonical: bool = False, seed: int = 42):
    """Plain version of :func:`kmer_hashes_packed_topk_planes`, on any
    device: the masked hashes of ``Np`` positions gathered into the TPU's
    groups, each sorted as unsigned, first 8 kept."""
    _check_codes(codes, k, length, t_hi, wide=True)
    N = codes.numel()
    Np = _padded_block(N)
    F, R, valid = _pack_windows(torch.nn.functional.pad(codes, (0, Np - N + k - 1), value=4),
                                Np, k)
    h = _canonical_murmur(F, R, k, noncanonical, seed)
    pos = torch.arange(Np, device=codes.device)
    keep = valid & (pos <= length - k) & (((h >> 32) & _PAD32) <= t_hi)
    h = torch.where(keep, h, -1)
    # [block c, row s, m, column j] -> group (c, j) of the 128 positions (s, m)
    groups = (h.view(-1, GROUPS, ROW_BLOCK // TOPK_WIDTH, TOPK_WIDTH)
              .permute(0, 3, 1, 2).reshape(-1, TOPK_WIDTH, GROUP))
    kept = torch.sort(groups ^ _SIGN, dim=2).values[..., :KEEP] ^ _SIGN  # [c, j, rank i]
    overflow = ((groups != -1).sum(dim=2) > KEEP).any()
    return (*split_planes(kept.permute(0, 2, 1).reshape(-1)), overflow)
