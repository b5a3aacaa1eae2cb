"""Duval (CFL) factor-start masks and the boundary-word algebra, in plain PyTorch.

Counterpart of the mask half of ``fpmash_tpu/ops/lyndon.py``.  A
factorization is carried as its *factor-start mask* ``bool[B, L]`` over a
zero-padded ``uint8[B, L]`` batch with a valid length per row; the
factorization families compose by OR-ing masks (``ops/factorize.py``).

* :func:`cfl_boundary_mask` — Duval's automaton for all rows in lockstep
  (the plain version of the Duval half of kernel ``csrc/factor_words.cu``,
  which replaces the Pallas kernel ``lyndon_pallas.py:30
  _duval_block_kernel``);
* :func:`pack_boundary_words` / :func:`unpack_boundary_words` — the mask as
  32-bit words (bit ``p & 31`` of word ``p >> 5`` is position ``p``), held
  in ``int32``: torch on the CPU has no ``uint32`` shifts;
* :func:`lengths_from_boundary` — factor lengths from a mask.
"""

from __future__ import annotations

import torch


def cfl_boundary_mask(batch: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Duval factor-start positions of each row as ``bool[B, L]``.

    ``batch`` is ``uint8[B, L]``; row ``b``'s word is its first
    ``lengths[b]`` bytes, compared as unsigned.  Every row's ``i/j/k``
    state steps in lockstep: extend the scan, emit a factor start, or start
    the next scan.
    """
    B, L = batch.shape
    dev = batch.device
    n = lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    # column L is a dump slot for rows that mark nothing this step
    mask = torch.zeros((B, L + 1), dtype=torch.bool, device=dev)
    i = torch.zeros(B, dtype=torch.int64, device=dev)
    j = torch.ones(B, dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    emitting = torch.zeros(B, dtype=torch.bool, device=dev)
    chars = batch.to(torch.int16)
    while L:
        done = i >= n
        if bool(done.all()):
            break
        s_k = chars.gather(1, k.clamp(0, L - 1)[:, None])[:, 0]
        s_j = chars.gather(1, torch.minimum(j, n - 1).clamp(0, L - 1)[:, None])[:, 0]
        scanning = ~emitting & ~done
        extend = scanning & (j < n) & (s_k <= s_j)
        emit_now = i <= k
        fire = emitting & ~done & emit_now
        reset = emitting & ~done & ~emit_now
        p = j - k
        mask.scatter_(1, torch.where(fire, i, L)[:, None], True)
        k = torch.where(extend, torch.where(s_k < s_j, i, k + 1), k)
        j = torch.where(extend, j + 1, j)
        i = torch.where(fire, i + p, i)
        j = torch.where(reset, i + 1, j)
        k = torch.where(reset, i, k)
        emitting = (emitting | (scanning & ~extend)) & ~reset
    return mask[:, :L]


def words_width(L: int) -> int:
    """Number of 32-bit boundary words for rows of up to ``L`` positions."""
    return max(1, -(-L // 32))


def pack_boundary_words(mask: torch.Tensor) -> torch.Tensor:
    """``bool[B, L]`` mask -> ``int32[B, ceil(L/32)]`` boundary words."""
    B, L = mask.shape
    W = words_width(L)
    bits = torch.zeros((B, W * 32), dtype=torch.int64, device=mask.device)
    bits[:, :L] = mask.to(torch.int64)
    shifts = torch.arange(32, device=mask.device)
    words = (bits.view(B, W, 32) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_boundary_words(words: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``int32[B, W]`` boundary words -> ``bool[B, 32 W]`` mask, cut to each
    row's valid length ``n``."""
    B, W = words.shape
    shifts = torch.arange(32, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shifts) & 1
    iota = torch.arange(W * 32, device=words.device)
    return (bits.view(B, W * 32) > 0) & (iota[None, :] < n.to(words.device)[:, None])


def lengths_from_boundary(boundary: torch.Tensor, n: torch.Tensor):
    """Factor-start ``bool[B, L]`` mask -> ``(fac_len int32[B, L],
    fac_count int32[B])``: the gaps between consecutive set bits (the last
    one up to ``n``), compacted to the left."""
    B, L = boundary.shape
    dev = boundary.device
    n = n.to(device=dev, dtype=torch.int64)[:, None]
    iota = torch.arange(L, device=dev)[None, :]
    boundary = boundary & (iota < n)
    bpos = torch.where(boundary, iota, L).sort(dim=1).values
    nxt = torch.cat([bpos[:, 1:], torch.full((B, 1), L, dtype=bpos.dtype, device=dev)], dim=1)
    fac_len = (torch.minimum(nxt, n) - torch.minimum(bpos, n)).clamp(min=0)
    return fac_len.to(torch.int32), boundary.sum(dim=1, dtype=torch.int32)
