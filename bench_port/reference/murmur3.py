"""MurmurHash3_x64_128 (Appleby's public-domain ``MurmurHash3.cpp``) over
batches of keys, in plain PyTorch on any device.

Values are ``int64`` tensors that hold the bits of unsigned 64-bit words:
products wrap modulo 2^64, and every right shift is made logical by a mask.
Only ``h1``, the first half of the digest, is returned: Mash keeps ``h1``
(64-bit hashes) or its low 32 bits.
"""

from __future__ import annotations

import torch

C1 = 0x87C37B91114253D5
C2 = 0x4CF5AD432745937F
FMIX1 = 0xFF51AFD7ED558CCD
FMIX2 = 0xC4CEB9FE1A85EC53
MASK64 = (1 << 64) - 1


def signed(value: int) -> int:
    """The ``int64`` that holds the bits of the unsigned ``value``."""
    value &= MASK64
    return value - (1 << 64) if value >= 1 << 63 else value


def unsigned(value: int) -> int:
    return value & MASK64


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _shr(k, 33)
    k = k * signed(FMIX1)
    k = k ^ _shr(k, 33)
    k = k * signed(FMIX2)
    return k ^ _shr(k, 33)


def _mix1(k1: torch.Tensor) -> torch.Tensor:
    return _rotl(k1 * signed(C1), 31) * signed(C2)


def _mix2(k2: torch.Tensor) -> torch.Tensor:
    return _rotl(k2 * signed(C2), 33) * signed(C1)


def murmur3_h1(words: list[torch.Tensor], nbytes, seed: int) -> torch.Tensor:
    """``h1`` of keys given as little-endian 64-bit words.

    ``words[i]`` holds word ``i`` of every key (bytes ``8 i .. 8 i + 7``,
    zero past the key's end), ``nbytes`` the length of each key in bytes (an
    ``int`` or an ``int64`` tensor).  Word pairs that lie wholly inside a key
    are blocks; the rest is the tail, mixed as the reference's switch does.
    """
    like = words[0]
    h1 = torch.full_like(like, seed & 0xFFFFFFFF)
    h2 = h1.clone()
    nbytes = torch.as_tensor(nbytes, dtype=torch.int64, device=like.device).expand_as(like)
    nblocks = nbytes // 16
    tail = nbytes & 15
    for b in range(len(words) // 2 + 1):
        k1 = words[2 * b] if 2 * b < len(words) else torch.zeros_like(like)
        k2 = words[2 * b + 1] if 2 * b + 1 < len(words) else torch.zeros_like(like)
        block = nblocks > b
        n1 = _rotl(h1 ^ _mix1(k1), 27) + h2
        n1 = n1 * 5 + 0x52DCE729
        n2 = _rotl(h2 ^ _mix2(k2), 31) + n1
        n2 = n2 * 5 + 0x38495AB5
        # the tail: its second word (bytes 8-15) goes into h2, its first into h1
        is_tail = nblocks == b
        t2 = torch.where(is_tail & (tail > 8), h2 ^ _mix2(k2), h2)
        t1 = torch.where(is_tail & (tail > 0), h1 ^ _mix1(k1), h1)
        h1 = torch.where(block, n1, t1)
        h2 = torch.where(block, n2, t2)
    h1 = h1 ^ nbytes
    h2 = h2 ^ nbytes
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    return h1 + h2


def murmur3_bytes(data: bytes, seed: int) -> int:
    """``h1`` of one byte string (for tests and scalar walks)."""
    padded = data + b"\0" * (-len(data) % 8 + 8)
    words = [torch.tensor([signed(int.from_bytes(padded[i : i + 8], "little"))])
             for i in range(0, len(padded), 8)]
    return unsigned(int(murmur3_h1(words, len(data), seed)[0]))
