"""Standard genetic code: 6-frame translation for amino-acid screening.

Copy of :mod:`fpmash_tpu.utils.codon`.  Replaces the reference's
``translate``/``aaFromCodon`` (CommandScreen.cpp:404-620): nucleotide
mixtures are 6-frame translated when screened against an amino-acid sketch;
stop codons and codons containing any non-ACGT character map to ``'*'``,
which invalidates every k-mer window covering them (hashSequence,
CommandScreen.cpp:336).
"""

from __future__ import annotations

import numpy as np

from fpmash_tpu_torch.ops.kmers import complement_table

# codon index = 16*b0 + 4*b1 + b2 with T=0, C=1, A=2, G=3 (standard layout)
_AA_BY_INDEX = (
    "FFLLSSSSYY**CC*W"  # TTT TTC TTA TTG TCT ... TGG
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)

_BASE_INDEX = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"TCAG"):
    _BASE_INDEX[_c] = _i

_AA_LUT = np.frombuffer(_AA_BY_INDEX.encode(), np.uint8)


def translate(seq: bytes | str, frame: int = 0) -> str:
    """Translate ``seq`` from ``frame`` (0-2); '*' for stops/invalid."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", "replace")
    n = (len(seq) - frame) // 3
    if n <= 0:
        return ""
    b = np.frombuffer(seq, np.uint8)[frame : frame + n * 3]
    idx = _BASE_INDEX[b].reshape(n, 3)
    invalid = (idx == 4).any(axis=1)
    code = idx[:, 0].astype(np.int32) * 16 + idx[:, 1] * 4 + idx[:, 2]
    aa = _AA_LUT[np.where(invalid, 14, code)]  # 14 = a '*' slot
    aa = np.where(invalid, np.uint8(ord("*")), aa)
    return aa.tobytes().decode("ascii")


def six_frame_translations(seq: str, preserve_case: bool = False) -> list[str]:
    """The six translations hashSequence iterates (CommandScreen.cpp:311-325):
    frames 0-2 of the sequence and frames 0-2 of its IUPAC reverse
    complement, after case folding (unless ``preserve_case``)."""
    b = seq.encode("ascii", "replace") if isinstance(seq, str) else bytes(seq)
    if not preserve_case:
        b = bytes(c - 32 if 96 < c < 123 else c for c in b)
    ctab = complement_table()
    rev = bytes(ctab[c] for c in b)[::-1]
    return [translate(b, f) for f in range(3)] + [translate(rev, f) for f in range(3)]
