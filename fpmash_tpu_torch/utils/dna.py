"""Pseudo-random DNA generation (lyn2vec/dna_utils.py equivalents; copy of
:mod:`fpmash_tpu.utils.dna`, so ``generate --seed`` writes the same bytes)."""

from __future__ import annotations

import random
import string


def make_dna(length: int, gc_content: float, rng: random.Random | None = None) -> str:
    """Random DNA with the given GC content (dna_utils.py:7-34):
    each base is G/C with probability gc_content (split evenly), else A/T."""
    if not 0 <= gc_content <= 1:
        raise ValueError("GC content must be within [0, 1].")
    rng = rng or random
    out = []
    for _ in range(length):
        if rng.random() < gc_content:
            out.append("G" if rng.random() < 0.5 else "C")
        else:
            out.append("A" if rng.random() < 0.5 else "T")
    return "".join(out)


def generate_dna_sequences(
    num: int, size: int, gc_content: float, rng: random.Random | None = None
) -> list[str]:
    return [make_dna(size, gc_content, rng) for _ in range(num)]


def generate_transcript_id(rng: random.Random | None = None, length: int = 8) -> str:
    """'T00000' + 8 random alphanumerics, uppercased (dna_utils.py:38-51)."""
    rng = rng or random
    chars = string.ascii_letters + string.digits
    return "T00000" + "".join(rng.choice(chars) for _ in range(length)).upper()


def generate_gene_id(transcript_id: str) -> str:
    """Replace the leading 'T' with 'G' (dna_utils.py:55-67)."""
    if not transcript_id:
        raise ValueError("empty transcript ID")
    return "G" + transcript_id[1:]
