"""A plain FASTA/FASTQ reader: ``(header, sequence)`` pairs, where the header
is the line after ``>`` or ``@`` and the sequence its lines joined."""

from __future__ import annotations


def read_records(path: str) -> list[tuple[str, str]]:
    with open(path) as fh:
        lines = fh.read().splitlines()
    out = []
    if lines and lines[0].startswith("@"):
        for i in range(0, len(lines) - 3, 4):
            out.append((lines[i][1:], lines[i + 1]))
        return out
    for line in lines:
        if line.startswith(">"):
            out.append((line[1:], []))
        elif out:
            out[-1][1].append(line.strip())
    return [(h, "".join(parts)) for h, parts in out]
