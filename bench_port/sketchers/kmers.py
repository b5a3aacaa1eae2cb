"""Mash's classic sketch of each input (``reference/kmers.py``): a genome's
bottom-s canonical k-mer hashes, or a read set's bottom-s hashes seen at
least ``read_min_copies`` times, with their counts.  As the control, one
precision down: 32-bit hashes where 64 are stated."""

import torch

from bench_port.harness.check import Want
from bench_port.reference import kmers as ref_kmers


def _entry(item, cfg: dict, expect: dict, device, bits: int) -> list[Want]:
    k, s, seed = cfg["kmer"], cfg["sketch_size"], cfg["hash_seed"]
    use64 = bits == 64
    if expect["mode"] == "genome":
        (seq,) = item.seqs
        values, _ = ref_kmers.genome_sketch(torch.from_numpy(seq).to(device), k, s, seed, use64)
        return [Want(str(item.path), item.headers[0], len(seq), values, None)]
    (rows,) = item.seqs  # a read set: one sketch of all reads, with counts
    parts = []
    step = max(1, (1 << 23) // rows.shape[1])
    for r in range(0, rows.shape[0], step):
        parts.append(ref_kmers.sketch_rows(torch.from_numpy(rows[r : r + step]).to(device),
                                           k, seed, use64))
    keys, counts = ref_kmers.merge_counts(parts) if len(parts) > 1 else parts[0]
    values, counts = ref_kmers.bottom_s(keys, counts, s, cfg["read_min_copies"])
    n = rows.shape[0]
    first = item.headers[0]
    comment = f"[{n} seqs] {first} [...]" if n > 1 else first
    return [Want(str(item.path), comment, ref_kmers.set_size_estimate(values, s, bits), values,
                 counts)]


def entries(items, cfg: dict, expect: dict, device, control: bool) -> list[list[Want]]:
    bits = cfg["hash_bits"] // 2 if control else cfg["hash_bits"]
    return [_entry(item, cfg, expect, device, bits) for item in items]
