"""K-finger extraction — sliding k-windows over fingerprints.

Rebuild of the reference's ML-classifier front-end helpers
(fingerprint_utils.py:9-90: ``computeWindow``, ``normalize``,
``get_enrich_str``).  A *k-finger* is a k-wide window of a fingerprint's
factor-length list, normalized to the lexicographic minimum of itself and
its reverse; the optional "enriched string" is a 20-char padded
reverse-complement snippet of the window's longest interior factor.

A copy of :mod:`fpmash_tpu.utils.kfinger` (host code, no device work): the
port imports nothing of the JAX package.  No verb of either CLI reaches it.
"""

from __future__ import annotations

from typing import Sequence

from fpmash_tpu_torch.scalar.lyndon import reverse_complement


def normalize(k_finger: list) -> list:
    """Lexicographic min of the window and its reverse
    (fingerprint_utils.py:76-90)."""
    rev = k_finger[::-1]
    for a, b in zip(k_finger, rev):
        if int(a) < int(b):
            return k_finger
        if int(b) < int(a):
            return rev
    return k_finger


def enrich_string(facts: Sequence[str]) -> str | None:
    """20-char padded enriched string from a window's factor strings
    (fingerprint_utils.py:40-72): drop first/last factor, take the longest
    remaining (ties -> the earliest, scanning from the right like the
    reference), reverse-complement it, and clip >20-char strings to the
    first and last 10 characters.
    """
    facts = list(facts)
    if len(facts) <= 2:
        return None
    inner = facts[1:-1]
    if len(inner) == 1:
        base = inner[0]
        if len(base) <= 20:
            s = reverse_complement(base)
        else:
            clipped = base[:10] + base[-10:]
            s = reverse_complement(clipped)
    else:
        best = ""
        for fact in inner[::-1]:
            if len(fact) > len(best):
                best = fact
        s = reverse_complement(best)
        if len(s) <= 20:
            # double reverse-complement = identity (reference quirk kept
            # for parity: :62-63 re-complements short strings back)
            s = reverse_complement(s)
        else:
            clipped = s[:10] + s[-10:]
            s = reverse_complement(clipped)
    return s + "N" * (20 - len(s)) if len(s) <= 20 else s


def compute_windows(
    lengths: Sequence[int],
    k: int,
    extended: bool = False,
    facts: Sequence[str] | None = None,
) -> list[list]:
    """All k-wide windows of a fingerprint, normalized; optionally with the
    enriched string appended (fingerprint_utils.py:9-36).

    ``extended`` pads fingerprints shorter than ``k`` with ``-1`` entries.
    """
    lengths = list(lengths)
    facts_list = list(facts) if facts is not None else None
    if len(lengths) < k and extended:
        pad = k - len(lengths)
        lengths = lengths + [-1] * pad
        if facts_list is not None:
            facts_list = facts_list + [""] * pad

    out = []
    stop = len(lengths) - (k - 1)
    for e in range(max(stop, 0)):
        window = lengths[e : e + k]
        enriched = None
        if facts_list is not None:
            enriched = enrich_string(facts_list[e : e + k])
        window = normalize(window)
        if facts_list is not None:
            window = list(window) + [enriched]
        out.append(list(window))
    return out
