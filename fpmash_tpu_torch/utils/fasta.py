"""FASTA / FASTQ / gzip sequence reader (copy of :mod:`fpmash_tpu.utils.fasta`).

Every plain file goes through the native C++ batch reader
(:mod:`fpmash_tpu_torch.utils.native`, built from ``native/fpio.cpp``), as
in the JAX package, whose CLI reads plain files with it; ``.gz`` files and
``-`` (stdin) through the pure-Python streaming parser.  The two differ on
CRLF line ends, blanks inside sequence lines and some malformed FASTQ, so a
plain file never takes the Python parser (``native=False`` asks for it).
Records are ``(name, comment, sequence)`` tuples.  The writers of
``generate`` (:func:`write_fasta`, :func:`write_fastq`) are copied too.
"""

from __future__ import annotations

import gzip
import io
from itertools import repeat
from typing import Iterable, Iterator, NamedTuple


class SeqRecord(NamedTuple):
    name: str
    comment: str
    seq: str


def _open_text(path: str):
    if path == "-":  # stdin, like the reference's gzdopen(fileno(stdin))
        import sys

        return io.StringIO(sys.stdin.read())
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def reader(path: str, native: bool = True) -> str:
    """Which parser :func:`read_sequences` reads ``path`` with:
    ``"native"`` or ``"python"``."""
    return "python" if not native or path == "-" or path.endswith(".gz") else "native"


def read_sequences(path: str, native: bool = True) -> Iterator[SeqRecord]:
    """Stream records from a FASTA or FASTQ file (optionally .gz).

    FASTA: ``>name comment`` header, multi-line sequence.
    FASTQ: 4-line records ``@name comment / seq / + / qual``.
    Format is sniffed from the first non-empty character, like kseq.

    A plain file goes through the native parser (see the module's
    docstring); a failed build of it raises.
    """
    if reader(path, native) == "native":
        from fpmash_tpu_torch.utils.native import parse_seq_file

        names, comments, blob, offsets = parse_seq_file(path)
        text = blob.decode("ascii", "replace")
        offsets = offsets.tolist()
        seqs = map(text.__getitem__, map(slice, offsets[:-1], offsets[1:]))
        # one record a read, built without a Python-level call per record
        yield from map(tuple.__new__, repeat(SeqRecord), zip(names, comments, seqs))
        return

    with _open_text(path) as fh:
        first = fh.read(1)
        while first in ("\n", "\r", " "):
            first = fh.read(1)
        if first == "":
            return
        if first == ">":
            yield from _read_fasta(fh)
        elif first == "@":
            yield from _read_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _split_header(line: str) -> tuple[str, str]:
    # kseq keeps everything after the first whitespace run (including a
    # trailing \r on CRLF files) as the comment; preserved for byte-parity
    # of sketch comments.
    line = line.rstrip("\n")
    parts = line.split(None, 1)
    name = parts[0] if parts else ""
    comment = parts[1] if len(parts) > 1 else ""
    return name, comment


def _read_fasta(fh) -> Iterator[SeqRecord]:
    # The caller consumed the leading '>'.
    name, comment = _split_header(fh.readline())
    chunks: list[str] = []
    for line in fh:
        if line.startswith(">"):
            yield SeqRecord(name, comment, "".join(chunks))
            name, comment = _split_header(line[1:])
            chunks = []
        else:
            chunks.append(line.strip())
    yield SeqRecord(name, comment, "".join(chunks))


def _read_fastq(fh) -> Iterator[SeqRecord]:
    # The caller consumed the leading '@'.
    header = fh.readline()
    while True:
        name, comment = _split_header(header)
        seq = fh.readline().strip()
        fh.readline()  # '+' line
        qual = fh.readline()
        if not qual:
            if seq:
                yield SeqRecord(name, comment, seq)
            return
        yield SeqRecord(name, comment, seq)
        header = fh.readline()
        if not header:
            return
        if header.startswith("@"):
            header = header[1:]


def write_fasta(path: str, records: Iterable[tuple[str, str]], width: int = 70) -> None:
    """Write ``(header, seq)`` pairs as FASTA with fixed line width.

    Mirrors lyn2vec's generator output (lyn2vec.py:211-225, width 70).
    """
    with open(path, "w") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


def write_fastq(path: str, records: Iterable[tuple[str, str]], width: int = 70) -> None:
    """Write ``(header, seq)`` pairs as FASTQ with dummy qualities.

    The reference writes the sequence wrapped at 70 chars but the quality
    line unwrapped at full length (lyn2vec.py:217-223) — preserved.
    """
    with open(path, "w") as fh:
        for header, seq in records:
            wrapped = "\n".join(seq[i : i + width] for i in range(0, len(seq), width))
            fh.write(f"@{header}\n{wrapped}\n+\n{'I' * len(seq)}\n")
