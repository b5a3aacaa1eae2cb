"""MurmurHash3_x64_128 — scalar parity model.

Byte-exact reimplementation of the public-domain MurmurHash3 x64 128-bit
variant as used by the reference sketcher (mash/src/mash/MurmurHash3.cpp,
called from hash.cpp:12-73).  Two entry points mirror the reference's two
hashing units:

* :func:`hash_bytes` — hash a byte string (classic k-mer path, hash.cpp:12).
* :func:`hash_u64_vector` — hash a vector of uint64 factor lengths as its
  little-endian byte image, ``length = count * 8`` (fingerprint path,
  hash.cpp:45-73, called from Sketch.cpp:132).

The sketch keeps either the low 32 bits or the full low 64 bits of the
128-bit digest depending on ``alphabet_size ** k > 2**32`` (Sketch.cpp:1288).
Both correspond to the first bytes of the digest in memory, i.e. ``h1``.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 42) -> tuple[int, int]:
    """Return the 128-bit digest as ``(h1, h2)`` uint64 pair."""
    length = len(data)
    nblocks = length // 16
    h1 = seed
    h2 = seed

    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    for i in range(len(tail) - 1, -1, -1):
        if i >= 8:
            k2 ^= tail[i] << ((i - 8) * 8)
        else:
            k1 ^= tail[i] << (i * 8)
    if len(tail) > 8:
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
    if len(tail) > 0:
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2


def hash_bytes(data: bytes, seed: int = 42, use64: bool = True) -> int:
    """Hash a byte string; keep low 64 or low 32 bits (hash.cpp:12-40)."""
    h1, _ = murmur3_x64_128(data, seed)
    return h1 if use64 else h1 & 0xFFFFFFFF


def hash_u64_vector(values, seed: int = 42, use64: bool = False) -> int:
    """Hash a fingerprint vector of uint64 lengths (hash.cpp:45-73).

    The reference hashes the raw uint64 array with byte length
    ``len(values) * 8`` (Sketch.cpp:132); fingerprint mode forces k=1 over a
    10-char alphabet so ``use64`` is False there (sketchParameterSetup.cpp:78).
    """
    data = b"".join(struct.pack("<Q", int(v)) for v in values)
    h1, _ = murmur3_x64_128(data, seed)
    return h1 if use64 else h1 & 0xFFFFFFFF
