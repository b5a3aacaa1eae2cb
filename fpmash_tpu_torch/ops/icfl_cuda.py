"""Factor-start words of every family, and their hashes: kernels K3/K14 and K4.

Two kernels, each with its plain PyTorch version and wrapper:

* :func:`factor_words` (``csrc/factor_words.cu``) — the factor-start words
  of any of the ten lyn2vec families for windows ``flat[starts[b] :
  starts[b] + lengths[b]]`` of one ``uint8`` stream (the layout of
  ``ops/fused_cuda.py``).  It replaces the Pallas ICFL kernel
  ``icfl_pallas.py:88 _icfl_words_kernel`` (``icfl_words_fused``) and the
  Duval-mask kernel ``lyndon_pallas.py:30 _duval_block_kernel``
  (``cfl_boundaries_pallas``), and composes them as
  ``ops/factorize.py:factor_boundary_mask`` does.  Returns ``(words
  int32[B, W], ok bool[B])`` with ``W = max(1, ceil(max(lengths) / 32))``:
  bit ``p & 31`` of word ``p >> 5`` is set where a factor starts at ``p``
  (bit 0 when ``n > 0``).  ``ok`` is false only for a window that does not
  lie inside the stream; such a row has zero words.  Plans with an ICFL
  automaton take windows of up to :data:`MAX_ICFL_WIDTH` characters.
* :func:`hash_words` (``csrc/hash_words.cu``) — MurmurHash3_x64_128 of each
  row's factor-length vector straight from its words, and the factor count;
  it replaces ``icfl_pallas.py:291 _hash_words_kernel``
  (``hash_from_words_fused``).

32-bit words ride in ``int32`` (torch on the CPU has no ``uint32``
shifts).  A wrapper runs the plain version for tensors on the CPU and
launches its kernel for tensors on a CUDA device.  ``LAUNCHES`` counts the
kernels' launches: ``factor_words`` by the base automaton of the plan
(``cfl``: Duval only; ``icfl``; ``cfl_icfl``: both), and ``hash_words``.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.factorize import factor_boundary_mask, plan
from fpmash_tpu_torch.ops.fused_cuda import check_stream
from fpmash_tpu_torch.ops.lyndon import (
    lengths_from_boundary,
    pack_boundary_words,
    unpack_boundary_words,
    words_width,
)
from fpmash_tpu_torch.ops.murmur3 import murmur3_u64_batch

#: widest window a plan with an ICFL automaton takes (the JAX package's
#: device bound: its level records pack positions in 10 bits)
MAX_ICFL_WIDTH = 1023

_BASES = {"cfl": 0, "icfl": 1, "cfl_icfl": 2}

#: kernel launches in this process (the plain versions do not count)
LAUNCHES = {"cfl": 0, "icfl": 0, "cfl_icfl": 0, "hash_words": 0}


def _check_words(words, lengths):
    if (words.dim() != 2 or words.shape[1] < 1 or words.dtype != torch.int32
            or not words.is_contiguous()):
        raise ValueError(
            f"words must be contiguous int32 [B, W >= 1], got {words.dtype} {tuple(words.shape)}"
        )
    if lengths.shape != words.shape[:1] or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(
            f"lengths must be contiguous int32 [{words.shape[0]}], "
            f"got {lengths.dtype} {tuple(lengths.shape)}"
        )
    if words.device != lengths.device:
        raise ValueError(f"inputs on different devices: {words.device}, {lengths.device}")


def _max_len(lengths) -> int:
    return max(int(lengths.max()), 0) if lengths.numel() else 0


def factor_words(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, family: str):
    """``(words int32[B, W], ok bool[B])`` of ``family`` for each window."""
    check_stream(flat, starts, lengths)
    base, threshold, comb = plan(family)
    dev = flat.device
    if dev.type == "cpu":
        return factor_words_plain(flat, starts, lengths, family)
    if dev.type != "cuda":
        raise ValueError(f"factor_words runs on cpu or cuda tensors, not {dev}")
    max_len = _max_len(lengths)
    if base != "cfl" and max_len > MAX_ICFL_WIDTH:
        raise ValueError(
            f"{family} takes windows of up to {MAX_ICFL_WIDTH} characters on the card, "
            f"got {max_len}: route wider ones to the scalar model"
        )
    from fpmash_tpu_torch.ops._build import check, library

    B = starts.numel()
    W = words_width(max_len)
    words = torch.empty((B, W), dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return words, ok
    with torch.cuda.device(dev):
        code = library().fpmash_factor_words(
            flat.data_ptr(), flat.numel(), starts.data_ptr(), lengths.data_ptr(), B,
            _BASES[base], threshold or 0, int(comb), max_len, words.data_ptr(), W,
            ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "factor_words kernel launch")
    LAUNCHES[base] += 1
    return words, ok


def factor_words_plain(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                       family: str):
    """Plain PyTorch version of :func:`factor_words`, on any device: the
    windows are gathered into a zero-padded ``[B, max(lengths)]`` batch and
    factorized by ``ops/factorize.py:factor_boundary_mask``."""
    check_stream(flat, starts, lengths)
    dev = flat.device
    B, N = starts.numel(), flat.numel()
    n = lengths.to(torch.int64)
    inside = (starts >= 0) & (n >= 0) & (starts <= N - n)
    L = _max_len(lengths)
    n = torch.where(inside, n, 0)
    iota = torch.arange(L, device=dev)
    idx = (torch.where(inside, starts, 0)[:, None] + iota).clamp(0, max(N - 1, 0))
    batch = flat[idx] if N else torch.zeros((B, L), dtype=torch.uint8, device=dev)
    batch = torch.where(iota[None, :] < n[:, None], batch, 0).to(torch.uint8)
    mask, ok = factor_boundary_mask(batch, n, family)
    return pack_boundary_words(mask), ok & inside


def hash_words(words: torch.Tensor, lengths: torch.Tensor, seed: int = 42):
    """``(h1 int64[B], h2 int64[B], count int32[B])``: MurmurHash3_x64_128
    of each row's factor-length vector, read from its start words."""
    _check_words(words, lengths)
    dev = words.device
    if dev.type == "cpu":
        return hash_words_plain(words, lengths, seed)
    if dev.type != "cuda":
        raise ValueError(f"hash_words runs on cpu or cuda tensors, not {dev}")
    from fpmash_tpu_torch.ops._build import check, library

    B, W = words.shape
    h1 = torch.empty(B, dtype=torch.int64, device=dev)
    h2 = torch.empty(B, dtype=torch.int64, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return h1, h2, count
    with torch.cuda.device(dev):
        code = library().fpmash_hash_words(
            words.data_ptr(), W, lengths.data_ptr(), B, seed & ((1 << 64) - 1),
            h1.data_ptr(), h2.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "hash_words kernel launch")
    LAUNCHES["hash_words"] += 1
    return h1, h2, count


def hash_words_plain(words: torch.Tensor, lengths: torch.Tensor, seed: int = 42):
    """Plain PyTorch version of :func:`hash_words`, on any device: factor
    lengths by ``lengths_from_boundary`` (a start at 0 for every non-empty
    row; bits at or past ``n`` ignored), hashed by ``murmur3_u64_batch``.
    A row with ``n < 0`` or ``n > 32 W`` gets count -1 and zero hashes."""
    _check_words(words, lengths)
    B, W = words.shape
    n = lengths.to(torch.int64)
    valid = (n >= 0) & (n <= 32 * W)
    n = torch.where(valid, n, 0)
    mask = unpack_boundary_words(words, n)
    mask[:, 0] |= n > 0
    fac_len, count = lengths_from_boundary(mask, n)
    h1, h2 = murmur3_u64_batch(fac_len.to(torch.int64), count, seed)
    return (torch.where(valid, h1, 0), torch.where(valid, h2, 0),
            torch.where(valid, count, -1).to(torch.int32))
