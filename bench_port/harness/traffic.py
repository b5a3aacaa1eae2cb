"""The inputs of a cell: a pool made from the seed, and the jobs that draw on it.

A traffic file (``bench_port/traffic/<mix>.json``) names a ``generator``
kind and its ``params``.  Each kind is one module,
``bench_port/generators/<kind>.py``, whose ``make(rng, out, params)`` writes
the pool's files under ``out`` and takes every size from ``params``; the
helpers they share are here.  Every seed gives the same sizes and the same
number of bases a job, in another order and with other letters.

A job is a tuple of pool indices: ``params["inputs_per_job"]`` of them
(default 1), distinct within a job.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bench_port.harness import spec

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.zeros(256, np.uint8)
COMPLEMENT[list(b"ACGT")] = list(b"TGCA")


@dataclass
class Item:
    """One input file: its path, its records' headers and sequences (``uint8``
    rows, for the reference) and the bases it holds."""

    path: Path
    headers: list[str]
    seqs: list[np.ndarray] = field(repr=False)
    bases: int = 0


@dataclass
class Pool:
    items: list[Item]
    inputs_per_job: int

    def jobs(self, rng: np.random.Generator):
        """Endless job draws: tuples of item indices."""
        n, k = len(self.items), self.inputs_per_job
        if k == n == 1:
            while True:
                yield (0,)
        while True:
            if k == 1:  # every item once a round, each round in a new order
                yield from ((int(i),) for i in rng.permutation(n))
            else:
                yield tuple(int(i) for i in rng.choice(n, size=k, replace=False))


def bases(rng, n: int, gc: float) -> np.ndarray:
    """``n`` random letters, G and C each ``gc / 2`` of them."""
    u = rng.random(n)
    at = (1.0 - gc) / 2
    codes = sum((u >= cut).astype(np.uint8) for cut in (at, 2 * at, 2 * at + gc / 2))
    return np.frombuffer(b"ATCG", np.uint8)[codes]  # A, T, C, G by threshold


def substitute(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """``seq`` with each letter replaced by another with probability ``rate``."""
    out = seq.copy()
    hit = np.flatnonzero(rng.random(len(seq)) < rate)
    code = np.searchsorted(ACGT, out[hit])
    out[hit] = ACGT[(code + rng.integers(1, 4, len(hit))) % 4]
    return out


def fasta_bytes(header: str, seq: np.ndarray, width: int) -> bytes:
    n = len(seq)
    full = n // width * width
    body = np.full((n // width, width + 1), ord("\n"), np.uint8)
    body[:, :width] = seq[:full].reshape(-1, width)
    tail = seq[full:].tobytes() + b"\n" if n > full else b""
    return b">" + header.encode() + b"\n" + body.tobytes() + tail


def make_pool(traffic: dict, seed: int, out: Path,
              root: Path = spec.ROOT) -> tuple[Pool, np.random.Generator]:
    """The traffic's pool, written under ``out``, and the generator that
    then draws its jobs (both from ``seed``)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    pool = spec.module("generators", traffic["generator"], root).make(rng, out, traffic["params"])
    return pool, rng
