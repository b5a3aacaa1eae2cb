"""Chen–Fox–Lyndon factorization — scalar parity model.

The CFL part of :mod:`fpmash_tpu.scalar.lyndon`, which is validated against
the reference's golden fingerprint files (tests/golden).  The other
factorization families arrive with the port of the ICFL kernels.
"""

from __future__ import annotations


def cfl(word: str, T=None) -> list[str]:
    """Chen–Fox–Lyndon factorization by Duval's algorithm, O(n).

    Returns the unique factorization of ``word`` into a non-increasing
    sequence of Lyndon words.  Parity target: reference factorizations.py:102
    (``CFL``) and factorizations_comb.py:22 (``duval_``).
    """
    factors = []
    n = len(word)
    i = 0
    while i < n:
        # Scan the maximal prefix of word[i:] that is a power of a Lyndon
        # word: j runs ahead, k trails the period start.
        j = i + 1
        k = i
        while j < n and word[k] <= word[j]:
            k = i if word[k] < word[j] else k + 1
            j += 1
        period = j - k
        while i <= k:
            factors.append(word[i : i + period])
            i += period
    return factors
