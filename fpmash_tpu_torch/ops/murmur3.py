"""Batched MurmurHash3_x64_128 in plain PyTorch, and the 64-bit convention.

**The convention.** Hashes and other unsigned 64-bit values are carried as
``torch.int64`` holding the same bits.  PyTorch on the CPU does not
implement ``>>``, ``<<``, ``+`` or ``<`` for ``uint64``; ``int64``
multiplication, addition and left shift wrap bit-exactly, so only two
operations need care, and both live here:

* :func:`shr` — a logical right shift (arithmetic shift, then mask);
* :func:`ult` — an unsigned compare (flip the sign bit of both sides,
  :func:`flip_sign`, whose signed order is the unsigned order of the bits).

:func:`to_signed` turns an unsigned Python constant into its ``int64``
image; ``numpy`` arrays of ``uint64`` cross with ``.view(np.int64)``.

:func:`murmur3_u64_batch` is the counterpart of
``fpmash_tpu.ops.murmur3.murmur3_u64_batch`` (XLA there, not Pallas), the
fingerprint hashing unit of hash.cpp:45-73: one vector of ``n`` u64 values
hashes as its ``8 n``-byte little-endian image.  :func:`murmur3_bytes_batch`
is the counterpart of ``murmur3_bytes_batch``, the classic k-mer hashing
unit of hash.cpp:12-40: each row hashes as its first ``lengths[b]`` bytes.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_SIGN = -(1 << 63)


def to_signed(x: int) -> int:
    """The ``int64`` value with the same bits as the unsigned ``x``."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of ``int64`` bits by ``0 < r < 64``."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr(x, 64 - r)


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its sign bit flipped: signed order of the result is the
    unsigned order of ``x``'s bits, and flipping again gives ``x`` back."""
    return x ^ _SIGN


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b`` of ``int64`` bits."""
    return flip_sign(a) < flip_sign(b)


_C1 = to_signed(0x87C37B91114253D5)
_C2 = to_signed(0x4CF5AD432745937F)
_F1 = to_signed(0xFF51AFD7ED558CCD)
_F2 = to_signed(0xC4CEB9FE1A85EC53)
_A1 = 0x52DCE729
_A2 = 0x38495AB5


def _fmix64(k):
    k = k ^ shr(k, 33)
    k = k * _F1
    k = k ^ shr(k, 33)
    k = k * _F2
    return k ^ shr(k, 33)


def _mix_k1(k1):
    return rotl(k1 * _C1, 31) * _C2


def _mix_k2(k2):
    return rotl(k2 * _C2, 33) * _C1


def _block_update(h1, h2, k1, k2):
    h1 = h1 ^ _mix_k1(k1)
    h1 = rotl(h1, 27) + h2
    h1 = h1 * 5 + _A1
    h2 = h2 ^ _mix_k2(k2)
    h2 = rotl(h2, 31) + h1
    h2 = h2 * 5 + _A2
    return h1, h2


def murmur3_u64_batch(vals: torch.Tensor, counts: torch.Tensor, seed: int = 42):
    """Hash each row of ``vals`` (``int64 [B, L]``) over its first ``counts[b]``
    elements; returns ``(h1, h2)``, each ``int64 [B]``, on ``vals.device``.

    Elements beyond ``counts`` are ignored.  The loop runs over the batch's
    largest block count, read once on the host.
    """
    if vals.dim() != 2 or vals.dtype != torch.int64:
        raise ValueError(f"vals must be int64 [B, L], got {vals.dtype} {tuple(vals.shape)}")
    B, L = vals.shape
    counts = counts.to(device=vals.device, dtype=torch.int64)
    lane = torch.arange(L, device=vals.device)
    vals = torch.where(lane[None, :] < counts[:, None], vals, 0)
    if L % 2:
        vals = torch.nn.functional.pad(vals, (0, 1))
        L += 1

    nblocks = counts // 2
    h1 = torch.full((B,), to_signed(seed), dtype=torch.int64, device=vals.device)
    h2 = h1.clone()
    max_blocks = int(nblocks.max()) if B else 0
    for blk in range(max_blocks):
        n1, n2 = _block_update(h1, h2, vals[:, 2 * blk], vals[:, 2 * blk + 1])
        full = blk < nblocks
        h1 = torch.where(full, n1, h1)
        h2 = torch.where(full, n2, h2)

    # odd tail: exactly one u64, mixed into k1 only
    if L:
        tail = vals.gather(1, (counts - 1).clamp(min=0)[:, None])[:, 0]
        h1 = torch.where(counts % 2 == 1, h1 ^ _mix_k1(tail), h1)
    return _finalize(h1, h2, counts * 8)


def murmur3_bytes_batch(data: torch.Tensor, lengths: torch.Tensor, seed: int = 42):
    """Hash each row of ``data`` (``uint8 [B, L]``) over its first
    ``lengths[b]`` bytes; returns ``(h1, h2)``, each ``int64 [B]``.

    Bytes beyond ``lengths`` are ignored.  Rows pack into little-endian u64
    words; full 16-byte blocks run while ``block < lengths // 16``, and the
    1-15 tail bytes, zero-padded, mix into ``k1`` (bytes 0-7) and ``k2``
    (bytes 8-15) as in the reference.
    """
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8 [B, L], got {data.dtype} {tuple(data.shape)}")
    B, L = data.shape
    lengths = lengths.to(device=data.device, dtype=torch.int64)
    pos = torch.arange(L, device=data.device)
    data = torch.where(pos[None, :] < lengths[:, None], data, 0)
    pad = (-L) % 16 + 16  # whole blocks, and one spare zero block for the tail
    # 8 bytes viewed as one int64 are the little-endian word (CPUs and GPUs
    # that run this are little-endian)
    words = torch.nn.functional.pad(data, (0, pad)).view(torch.int64)
    nblocks = lengths // 16

    h1 = torch.full((B,), to_signed(seed), dtype=torch.int64, device=data.device)
    h2 = h1.clone()
    max_blocks = int(nblocks.max()) if B else 0
    for blk in range(max_blocks):
        n1, n2 = _block_update(h1, h2, words[:, 2 * blk], words[:, 2 * blk + 1])
        full = blk < nblocks
        h1 = torch.where(full, n1, h1)
        h2 = torch.where(full, n2, h2)

    tail = lengths % 16
    k1 = words.gather(1, (2 * nblocks)[:, None])[:, 0]
    k2 = words.gather(1, (2 * nblocks + 1)[:, None])[:, 0]
    h2 = torch.where(tail > 8, h2 ^ _mix_k2(k2), h2)
    h1 = torch.where(tail > 0, h1 ^ _mix_k1(k1), h1)
    return _finalize(h1, h2, lengths)


def _finalize(h1, h2, byte_len):
    """MurmurHash3_x64_128's closing mix of ``(h1, h2)`` with the length."""
    h1 = h1 ^ byte_len
    h2 = h2 ^ byte_len
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2
