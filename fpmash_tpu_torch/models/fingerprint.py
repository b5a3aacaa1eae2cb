"""Fingerprint front-end: reads and their cyclic shift windows.

Copy of the parts of :mod:`fpmash_tpu.models.fingerprint` that
``sketch --direct-fp`` needs (lyn2vec fingerprint_utils.py).  A fingerprint
of a window is the sequence of its Lyndon factor lengths; in "shift" mode
every cyclic 100-wide window of a read is fingerprinted.
"""

from __future__ import annotations

from fpmash_tpu_torch.utils.fasta import read_sequences

SHIFT_WINDOW = 100  # fingerprint_utils.py:456: shift_string(read, 100, shift)


def extract_reads(path: str, rev_com: bool = False) -> list[tuple[str, str]]:
    """Return ``(id, SEQUENCE)`` pairs for the *basic* pipeline.

    The line ID is the FASTA header's *second* token (the gene ID — the
    reference keeps ``s_list[1]``, fingerprint_utils.py:282-289), falling
    back to the first token when there is no second.  Sequences are
    uppercased (fingerprint_utils.py:365).

    ``rev_com=True`` reproduces the reference fixtures exactly: IDs gain a
    ``_0`` suffix and — because the reference appends reverse-complement
    lines under an inverted condition that never fires
    (fingerprint_utils.py:276-277,305-306) — *no* ``_1`` reverse-complement
    reads are emitted.  ``rev_com=False`` yields plain IDs.
    """
    out = []
    for rec in read_sequences(path):
        rid = rec.comment.split()[0] if rec.comment else rec.name
        seq = rec.seq.upper()
        out.append((rid + "_0", seq) if rev_com else (rid, seq))
    return out


def shift_windows(seq: str, size: int = SHIFT_WINDOW) -> list[str]:
    """All cyclic ``size``-wide windows of ``seq`` (fingerprint_utils.py:95).

    A sequence shorter than ``size`` yields itself unchanged; otherwise
    window ``i`` is ``seq[i:i+size]`` wrapping around the start.
    """
    n = len(seq)
    if n < size:
        return [seq]
    doubled = seq + seq[: size - 1]
    return [doubled[i : i + size] for i in range(n)]
