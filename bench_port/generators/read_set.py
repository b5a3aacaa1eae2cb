"""A sequenced read set: one FASTQ of ``reads`` reads of ``read_length`` bases
from both strands of a random genome of ``genome_length`` bases, each base
substituted with probability ``substitution``.  Every job takes it."""

import numpy as np

from bench_port.harness.traffic import COMPLEMENT, Item, Pool, bases, substitute


def make(rng, out, p: dict) -> Pool:
    genome = bases(rng, p["genome_length"], p["gc"])
    n, rl = p["reads"], p["read_length"]
    starts = rng.integers(0, len(genome) - rl + 1, n)
    reads = genome[starts[:, None] + np.arange(rl)[None, :]]
    flip = rng.random(n) < 0.5
    reads[flip] = COMPLEMENT[reads[flip, ::-1]]
    reads = substitute(rng, reads.reshape(-1), p["substitution"]).reshape(n, rl)
    digits = len(str(n - 1))
    ids = (np.arange(n)[:, None] // 10 ** np.arange(digits - 1, -1, -1)[None, :]) % 10 + 48
    nl = np.full((n, 1), ord("\n"), np.uint8)
    rec = np.concatenate([np.full((n, 1), ord("@"), np.uint8), np.full((n, 1), ord("r"), np.uint8),
                          ids.astype(np.uint8), nl, reads, nl,
                          np.full((n, 1), ord("+"), np.uint8), nl,
                          np.full((n, rl), ord(p["quality"]), np.uint8), nl], axis=1)
    path = out / "reads.fq"
    path.write_bytes(rec.tobytes())
    headers = [f"r{0:0{digits}d}"]  # the reference needs the first read's name alone
    return Pool([Item(path, headers, [reads], reads.size)], 1)
