"""The card's peaks, and the least time the work of a window could take.

Copied from ``chip_smoke.py`` (``_bound`` and its constants): a kernel's
bound is the larger of its bytes (each input byte read once, each output
byte written once) over the memory rate and its 32-bit integer operations
over the integer rate, both from the data sheet of the H100 SXM at its full
power limit of 700 W.
"""

from __future__ import annotations

#: HBM3 bytes/s (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations/s: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT_OPS_PER_S = 132 * 64 * 1.98e9
#: operations of MurmurHash3_x64_128 per 8-byte word it mixes, and of its finalization
MURMUR_WORD_OPS, MURMUR_FINAL_OPS = 20, 40


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def kmer_work(positions: int, k: int) -> tuple[float, float]:
    """``(bytes, operations)`` of hashing ``positions`` canonical k-mers: the
    letters read once; about 10 operations a position for the codes, the
    rolling forward and reverse-complement words and the canonical pick, then
    MurmurHash3 of the k bytes (``chip_smoke.py``, K5-K8)."""
    return positions, positions * (10 + MURMUR_WORD_OPS * -(-k // 8) + MURMUR_FINAL_OPS)


def window_work(stream_bytes: int, windows: int, chars: int, strands: int,
                factors: int) -> tuple[float, float]:
    """``(bytes, operations)`` of factorizing and hashing ``windows`` windows
    of ``chars`` letters in all, whose fingerprints hold ``factors`` factor
    lengths in all: the stream read once, a start and length in and three
    results out a window; one operation a letter on each strand, then
    MurmurHash3 of each window's factor lengths, one word a factor, and its
    finalization (``chip_smoke.py``'s K1 bound, with ``_hash_ops``)."""
    nbytes = stream_bytes + windows * (8 + 4 + 20)
    return nbytes, chars * strands + factors * MURMUR_WORD_OPS + windows * MURMUR_FINAL_OPS
