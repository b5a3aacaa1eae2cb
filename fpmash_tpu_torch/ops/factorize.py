"""All ten lyn2vec factorization families as boundary-mask algebra, in plain PyTorch.

Counterpart of ``fpmash_tpu/ops/factorize.py``.  Every family the
reference CLI offers (lyn2vec.py:47-72) is a factor-start mask over the
zero-padded ``uint8[B, L]`` batch, built from two automatons:

========================  ====================================================
CFL                       Duval mask (:func:`ops.lyndon.cfl_boundary_mask`)
ICFL                      inverse-Lyndon mask (:mod:`ops.icfl`)
CFL_ICFL-T                CFL mask | ICFL inside each CFL factor > T
CFL_COMB                  CFL(seq) | flip(CFL(revcomp(seq)))
ICFL_COMB                 ICFL(seq) | flip(ICFL(revcomp(seq)))
CFL_ICFL_COMB-T           CFL_ICFL-T(seq) | flip(CFL_ICFL-30(revcomp(seq)))
========================  ====================================================

The reference's COMB length merge (factorizations_comb.py:213-246) is the
common refinement of the two factorizations' cuts, and a cut at ``c`` of the
reverse complement cuts ``seq`` at ``n - c``.  The reverse-complement side
uses the default threshold 30 (reference quirk, factorizations_comb.py:
213-221); ``<<``/``>>`` markers carry no length.

These are the plain versions that kernel ``csrc/factor_words.cu``
(``ops/icfl_cuda.py``) is held against, and what the CPU path runs.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.icfl import cfl_icfl_boundary_mask, icfl_boundary_mask
from fpmash_tpu_torch.ops.lyndon import cfl_boundary_mask, lengths_from_boundary

#: Family name -> (base family, threshold, comb), name for name as the
#: reference dispatch table
FAMILY_PLANS = {
    "CFL": ("cfl", None, False),
    "ICFL": ("icfl", None, False),
    "CFL_ICFL-10": ("cfl_icfl", 10, False),
    "CFL_ICFL-20": ("cfl_icfl", 20, False),
    "CFL_ICFL-30": ("cfl_icfl", 30, False),
    "CFL_COMB": ("cfl", None, True),
    "ICFL_COMB": ("icfl", None, True),
    "CFL_ICFL_COMB-10": ("cfl_icfl", 10, True),
    "CFL_ICFL_COMB-20": ("cfl_icfl", 20, True),
    "CFL_ICFL_COMB-30": ("cfl_icfl", 30, True),
}

#: threshold of the reverse-complement side of CFL_ICFL_COMB-T
RC_THRESHOLD = 30

#: complement bytes: A<->T, C<->G, every other byte 'N' (the scalar model's
#: reverse_complement)
COMPLEMENT = [ord("N")] * 256
for _a, _b in ("AT", "TA", "CG", "GC"):
    COMPLEMENT[ord(_a)] = ord(_b)


def plan(family: str):
    """``(base, threshold, comb)`` of ``family``; raises ``ValueError``
    naming the known families."""
    try:
        return FAMILY_PLANS[family]
    except KeyError:
        raise ValueError(
            f"unknown factorization {family!r}; expected one of {sorted(FAMILY_PLANS)}"
        ) from None


def _base_mask(batch, n, base: str, threshold):
    if base == "cfl":
        return cfl_boundary_mask(batch, n), torch.ones(batch.shape[0], dtype=torch.bool,
                                                       device=batch.device)
    if base == "icfl":
        return icfl_boundary_mask(batch, n)
    return cfl_icfl_boundary_mask(batch, n, threshold)


def _revcomp_batch(batch, n):
    """Per-row reverse complement of the valid prefix, packed left, zero beyond."""
    B, L = batch.shape
    iota = torch.arange(L, device=batch.device)[None, :]
    idx = (n[:, None] - 1 - iota).clamp(0, max(L - 1, 0))
    lut = torch.tensor(COMPLEMENT, dtype=torch.uint8, device=batch.device)
    rc = lut[batch.gather(1, idx).to(torch.int64)]
    return torch.where(iota < n[:, None], rc, 0).to(torch.uint8)


def _flip_mask(mask, n):
    """Map reverse-complement factor starts ``c`` to forward cuts ``n - c``
    with each row's own ``n``: interior cuts ``c`` in ``[1, n-1]`` flip to
    ``[1, n-1]``; the rc start bit 0 drops out (bit 0 is the forward mask's)."""
    B, L = mask.shape
    iota = torch.arange(L, device=mask.device)[None, :]
    src = n[:, None] - iota
    valid = (iota >= 1) & (src >= 1)
    return mask.gather(1, src.clamp(0, max(L - 1, 0))) & valid


def factor_boundary_mask(batch: torch.Tensor, lengths: torch.Tensor, family: str):
    """Factor-start mask of any family: ``(mask bool[B, L], ok bool[B])``.

    ``ok`` is true for every row here; the kernel's ``ok`` has the same
    meaning (false: recompute the row on the host).
    """
    base, threshold, comb = plan(family)
    n = lengths.to(device=batch.device, dtype=torch.int64)
    mask, ok = _base_mask(batch, n, base, threshold)
    if comb:
        rc_thr = RC_THRESHOLD if base == "cfl_icfl" else threshold
        rc_mask, rc_ok = _base_mask(_revcomp_batch(batch, n), n, base, rc_thr)
        mask = mask | _flip_mask(rc_mask, n)
        ok = ok & rc_ok
    return mask, ok


def factor_lengths_device(batch: torch.Tensor, lengths: torch.Tensor, family: str):
    """Factor lengths of any family: ``(fac_len int32[B, L], fac_count
    int32[B], ok bool[B])``."""
    mask, ok = factor_boundary_mask(batch, lengths, family)
    fac_len, fac_count = lengths_from_boundary(mask, lengths)
    return fac_len, fac_count, ok


def encode_batch(windows) -> tuple[torch.Tensor, torch.Tensor]:
    """Strings (or bytes) -> ``(uint8[B, L] zero-padded, int32[B] lengths)``."""
    data = [w.encode("ascii") if isinstance(w, str) else bytes(w) for w in windows]
    L = max((len(d) for d in data), default=1)
    arr = torch.zeros((len(data), max(L, 1)), dtype=torch.uint8)
    for r, d in enumerate(data):
        if d:
            arr[r, : len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
    return arr, torch.tensor([len(d) for d in data], dtype=torch.int32)


def factorize_windows_device(windows, family: str, device) -> list[list[int]]:
    """Strings -> factor-length lists through the plain masks on ``device``;
    rows with ``ok`` false go to the scalar model."""
    from fpmash_tpu_torch.scalar.lyndon import FACTORIZATIONS

    arr, lens = encode_batch(windows)
    fac_len, fac_count, ok = factor_lengths_device(arr.to(device), lens.to(device), family)
    fac_len, fac_count, ok = fac_len.cpu(), fac_count.cpu(), ok.cpu()
    out = []
    for b, w in enumerate(windows):
        if ok[b]:
            out.append(fac_len[b, : fac_count[b]].tolist())
        else:
            out.append([len(f) for f in FACTORIZATIONS[family](w) if f not in ("<<", ">>")])
    return out
