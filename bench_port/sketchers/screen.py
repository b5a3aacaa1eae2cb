"""The plain reference's view of a screen cell's inputs (``reference/screen.py``):
the database's hashes as the generator drew them, and each read set's
distinct k-mer hashes with their multiplicities.  As the control, one
precision down: 32-bit hashes where 64 are stated, in both."""

import torch

from bench_port.reference import screen as ref_screen


def _entry(item, cfg: dict, device, bits: int):
    if hasattr(item, "seg_len"):  # the database
        return ref_screen.database(item.hashes, item.seg_len, item.lengths, item.headers,
                                   item.comments, bits, device)
    (rows,) = item.seqs
    return ref_screen.query(torch.from_numpy(rows).to(device), cfg["kmer"], cfg["hash_seed"],
                            bits)


def entries(items, cfg: dict, expect: dict, device, control: bool) -> list[list]:
    bits = cfg["hash_bits"] // 2 if control else cfg["hash_bits"]
    return [[_entry(item, cfg, device, bits)] for item in items]
