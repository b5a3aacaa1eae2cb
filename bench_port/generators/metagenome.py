"""A RefSeq-sized sketch database and metagenome read sets screened against it.

The database (``refseq.msh``) holds ``references`` sketches of ``kmer``-mers
at ``sketch_size`` hashes (seed ``hash_seed``), in a random order:

* ``genomes`` generated genomes of ``genome_length`` bases, in families of
  ``family_size`` that share a random ancestor of GC content drawn from
  ``gc``, each member ``divergence`` (drawn from the range) substituted away
  from it, each sketched by the plain reference (``reference/kmers.py``);
* the rest drawn as the bottom ``sketch_size`` hashes of a genome of ``L``
  bases, ``L`` log-uniform over ``distractor_length`` and stored as the
  length: the order statistics of ``L`` uniform 64-bit values, the
  cumulative sums of exponential gaps of mean ``2^64 / L``.

It is written by the plain writer ``reference/msh_writer.py``.  Each of
``read_sets`` FASTQ files holds ``reads`` reads of ``read_length`` bases from
both strands of ``present`` of the genomes (one or two members of every
family) at log-normal abundances (``abundance_sigma``), each base substituted
with probability ``substitution``.  A job screens one read set against the
database: the jobs take the read sets in turn, each round in a new order.

A program whose warm job runs past ``WARM_LIMIT_S`` cannot be measured in
this cell: its window would hold one or two jobs.  The run then stops with
``SlowWarmJob`` and exits non-zero, rather than run on for minutes to report
a rate from a single job.  Python takes the alarm only between bytecodes, so
a warm job held in one long C call (``np.unique`` of the database's hashes,
say) is stopped ``HARD_GRACE_S`` later by ``faulthandler``, which prints
every thread's stack and exits with status 1, leaving the run's inputs in
its temporary folder.
"""

import faulthandler
import signal
import sys
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_port.harness.traffic import ACGT, COMPLEMENT, Item, Pool, bases
from bench_port.reference import kmers as ref_kmers
from bench_port.reference.msh_writer import msh_bytes


@dataclass
class Database(Item):
    """The database's file and what it holds: ``headers`` are the names;
    ``hashes[sum(seg_len[:i]) :][: seg_len[i]]`` reference i's hashes."""

    comments: list = field(default_factory=list, repr=False)
    lengths: np.ndarray = field(default=None, repr=False)
    hashes: np.ndarray = field(default=None, repr=False)
    seg_len: np.ndarray = field(default=None, repr=False)


#: the longest warm job (seconds) that leaves a window of 51 s room for a rate
WARM_LIMIT_S = 60.0
#: seconds past ``WARM_LIMIT_S`` after which a warm job in one C call ends the process
HARD_GRACE_S = 30.0


class SlowWarmJob(BaseException):
    """The warm job ran past ``WARM_LIMIT_S``.  A ``BaseException``, so that
    the runner's count of failed jobs does not take it for one and run on."""


def _stop_alarms():
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()


def _slow(signum, frame):
    _stop_alarms()
    raise SlowWarmJob(f"bench_port: the warm job of a screen cell ran past {WARM_LIMIT_S:g} s; "
                      "a window would hold one or two jobs, so this program cannot be measured "
                      "in this cell")


def _arm():
    """Start the warm job's alarms; return the function that stops them."""
    before = signal.signal(signal.SIGALRM, _slow)
    signal.setitimer(signal.ITIMER_REAL, WARM_LIMIT_S)
    faulthandler.dump_traceback_later(WARM_LIMIT_S + HARD_GRACE_S, exit=True, file=sys.__stderr__)

    def disarm():
        _stop_alarms()
        signal.signal(signal.SIGALRM, signal.SIG_DFL if before is None else before)

    return disarm


class ScreenPool(Pool):
    """Item 0 is the database; every job is ``(0, read set)``.  The first job
    drawn is the warm one: on the main thread alarms bound it by
    ``WARM_LIMIT_S`` (``SlowWarmJob``) and ``HARD_GRACE_S`` more (exit 1),
    and the next draw stops them."""

    def jobs(self, rng):
        disarm = _arm() if threading.current_thread() is threading.main_thread() else None
        try:
            while True:
                for i in rng.permutation(len(self.items) - 1):
                    yield 0, 1 + int(i)
                    if disarm:
                        disarm()
                        disarm = None
        finally:
            if disarm:
                disarm()


def substitute(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """``seq`` with about ``rate`` of its letters, at random places, each
    replaced by another letter."""
    out = seq.copy()
    hit = np.unique(rng.integers(0, len(seq), rng.binomial(len(seq), rate)))
    code = np.searchsorted(ACGT, out[hit])
    out[hit] = ACGT[(code + rng.integers(1, 4, len(hit))) % 4]
    return out


def _genomes(rng, p: dict):
    """The genomes as rows of one array, and each one's family and divergence."""
    n, size, length = p["genomes"], p["family_size"], p["genome_length"]
    rows = np.empty((n, length), np.uint8)
    family, divergence = np.repeat(np.arange(n // size), size), np.zeros(n)
    for f in range(n // size):
        ancestor = bases(rng, length, float(rng.uniform(*p["gc"])))
        for m in range(size):
            divergence[f * size + m] = rng.uniform(*p["divergence"])
            rows[f * size + m] = substitute(rng, ancestor, divergence[f * size + m])
    return rows, family, divergence


def _distractors(rng, n: int, s: int, length_range) -> tuple[np.ndarray, np.ndarray]:
    """``(lengths, hashes[n, s])``: each row the ``s`` smallest of ``L`` uniform
    64-bit values, ascending and distinct."""
    lo, hi = np.log(length_range[0]), np.log(length_range[1])
    lengths = np.exp(rng.uniform(lo, hi, n)).astype(np.int64)
    gaps = rng.exponential(1.0, (n, s)) * (2.0**64 / lengths)[:, None]
    values = np.floor(np.cumsum(gaps, axis=1)).astype(np.int64)
    step = np.arange(s, dtype=np.int64)
    values = np.maximum.accumulate(values - step, axis=1) + step  # distinct where floor met
    return lengths, values.astype(np.uint64)


def _reads(rng, genomes: np.ndarray, family: np.ndarray, p: dict) -> np.ndarray:
    """One read set's reads as rows: from ``present`` genomes, one or two of
    each family, at log-normal abundances; both strands; substitutions."""
    families = np.unique(family)
    twice = set(rng.permutation(families)[: p["present"] - len(families)].tolist())
    chosen = []
    for f in families.tolist():
        members = np.flatnonzero(family == f)
        chosen += rng.choice(members, 2 if f in twice else 1, replace=False).tolist()
    weight = np.exp(rng.normal(0.0, p["abundance_sigma"], len(chosen)))
    n, rl = p["reads"], p["read_length"]
    source = np.asarray(chosen)[rng.choice(len(chosen), n, p=weight / weight.sum())]
    starts = rng.integers(0, genomes.shape[1] - rl + 1, n)
    flat = genomes.reshape(-1)
    reads = np.empty((n, rl), np.uint8)
    span = np.arange(rl)
    for r in range(0, n, 1 << 17):
        at = source[r : r + (1 << 17)] * genomes.shape[1] + starts[r : r + (1 << 17)]
        reads[r : r + (1 << 17)] = flat[at[:, None] + span]
    flip = rng.random(n) < 0.5
    reads[flip] = COMPLEMENT[reads[flip, ::-1]]
    return substitute(rng, reads.reshape(-1), p["substitution"]).reshape(n, rl)


def _fastq(reads: np.ndarray, tag: str, quality: str) -> bytes:
    n, rl = reads.shape
    digits = len(str(n - 1))
    ids = (np.arange(n)[:, None] // 10 ** np.arange(digits - 1, -1, -1)[None, :]) % 10 + 48
    col = lambda ch, w=1: np.full((n, w), ord(ch), np.uint8)  # noqa: E731
    name = np.frombuffer(tag.encode(), np.uint8)[None, :].repeat(n, 0)
    return np.concatenate([col("@"), name, ids.astype(np.uint8), col("\n"), reads, col("\n"),
                           col("+"), col("\n"), col(quality, rl), col("\n")], axis=1).tobytes()


def make(rng, out, p: dict) -> ScreenPool:
    k, s, seed = p["kmer"], p["sketch_size"], p["hash_seed"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    genomes, family, divergence = _genomes(rng, p)
    total, g = p["references"], p["genomes"]
    lengths, table = _distractors(rng, total - g, s, p["distractor_length"])
    at = np.sort(rng.choice(total, g, replace=False))  # the genomes' places in the database
    is_genome = np.zeros(total, bool)
    is_genome[at] = True
    rows = [None] * total
    for i, row in zip(np.flatnonzero(~is_genome).tolist(), table):
        rows[i] = row
    for i, seq in zip(at.tolist(), genomes):
        values, _ = ref_kmers.genome_sketch(torch.from_numpy(seq).to(device), k, s, seed)
        rows[i] = np.array(values, np.uint64)
    all_lengths = np.zeros(total, np.int64)
    all_lengths[~is_genome] = lengths
    all_lengths[at] = p["genome_length"]
    names = [f"GCF_{100003 + 7 * i:09d}.1_genomic.fna.gz" for i in range(total)]
    comments = [f"[1 seqs] NZ_SYN{i:06d}.1 synthetic distractor of {all_lengths[i]} bases [...]"
                for i in range(total)]
    for j, i in enumerate(at.tolist()):
        comments[i] = (f"[1 seqs] NZ_SYN{i:06d}.1 synthetic genome, family {family[j]}, "
                       f"divergence {divergence[j]:.4f} [...]")
    seg_len = np.fromiter(map(len, rows), np.int64, total)
    hashes = np.concatenate(rows)
    path = out / "refseq.msh"
    path.write_bytes(msh_bytes(kmer=k, sketch_size=s, seed=seed, alphabet="ACGT", canonical=True,
                               names=names, comments=comments, lengths=all_lengths,
                               hashes=hashes, seg_len=seg_len))
    items = [Database(path, names, [], 0, comments, all_lengths, hashes, seg_len)]
    for j in range(p["read_sets"]):
        reads = _reads(rng, genomes, family, p)
        fq = out / f"reads{j}.fq"
        fq.write_bytes(_fastq(reads, f"s{j}r", p["quality"]))
        items.append(Item(fq, [f"s{j}r"], [reads], reads.size))
    return ScreenPool(items, 2)
