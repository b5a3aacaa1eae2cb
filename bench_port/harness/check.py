"""Whether the timed jobs wrote the right answers.

Every step of every job that names a ``check`` has its output read back
after the job ends (its bytes, kept once per distinct content and input
set).  Once the window has closed, each distinct output is judged by the
check module ``bench_port/checks/<check>.py`` against the plain reference's
answer for that step's inputs, worked out again from the generated
sequences by the configuration's sketcher (``bench_port/sketchers/``).
The numbers compared are ``missing_outputs`` (steps that left no output)
and those each check module lists in its ``LIMITS``.

A check module has ``LIMITS`` (each number's limit), ``parse(bytes)``,
``expected(reference, groups)``, ``compare(got, want, reference) -> dict``
and ``render(want, reference)``, the answer in the form ``parse`` gives,
which the control puts in the program's place.  ``groups`` are the step's inputs as
tuples of pool indices (a step's ``inputs`` lists positions in the job, in
groups; by default one group of all of them).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from bench_port.harness import spec


@dataclass
class Want:
    """One sketch entry as the reference gives it."""

    name: str
    comment: str
    length: int
    hashes: list
    counts: list | None
    factors: int = 0  # factor lengths hashed (fingerprint entries)


class Reference:
    """The reference's sketch of each pool item, each worked out once; with
    ``control``, one precision down (the configuration's sketcher says how)."""

    def __init__(self, pool, cfg: dict, expect: dict, device, control: bool = False,
                 root: Path = spec.ROOT):
        self.pool, self.cfg, self.expect, self.device = pool, cfg, expect, device
        self.control = control
        self.sketcher = spec.module("sketchers", cfg["reference"], root)
        self.header = {"kmer": cfg["kmer"], "sketch_size": cfg["sketch_size"],
                       "seed": cfg["hash_seed"], "alphabet": cfg["alphabet"],
                       "noncanonical": not cfg["canonical"], "hash_bits": cfg["hash_bits"]}
        self._cache: dict[int, list[Want]] = {}

    def prefetch(self, indices) -> None:
        """Work out the entries of the pool items ``indices`` not known yet."""
        todo = sorted(set(indices) - set(self._cache))
        if todo:
            found = self.sketcher.entries([self.pool.items[i] for i in todo], self.cfg,
                                          self.expect, self.device, self.control)
            self._cache.update(zip(todo, found))

    def entries(self, idx: int) -> list[Want]:
        """The reference's entries for pool item ``idx``."""
        self.prefetch([idx])
        return self._cache[idx]


def groups(step: dict, job: tuple) -> tuple:
    """The step's inputs: tuples of pool indices, one a group."""
    picks = step.get("inputs", [list(range(len(job)))])
    return tuple(tuple(job[p] for p in g) for g in picks)


def checks(steps: list[dict], root: Path = spec.ROOT) -> list:
    """The check module of each step (None for a step with no ``check``)."""
    return [spec.module("checks", s["check"], root) if "check" in s else None for s in steps]


class Outputs:
    """What the timed jobs' steps wrote, kept once per step, input set and content."""

    def __init__(self, steps: list[dict], root: Path = spec.ROOT):
        self.steps, self.checks = steps, checks(steps, root)
        self.limits = {"missing_outputs": 0}  # every number compared, with its limit
        for c in self.checks:
            if c is not None:
                self.limits.update(c.LIMITS)
        self.kept: dict[tuple, list] = {}
        self.missing = 0
        self.seen = 0  # outputs due

    def add(self, step: int, job: tuple, data) -> None:
        """``data``: the step's output (bytes, or as its check parses it), or
        None if it left none."""
        if self.checks[step] is None:
            return
        self.seen += 1
        if data is None:
            self.missing += 1
            return
        kept = self.kept.setdefault((step, groups(self.steps[step], job)), [])
        if not any(d == data for d in kept):
            kept.append(data)

    def check(self, reference: Reference) -> dict:
        totals = dict.fromkeys(self.limits, 0)
        totals["missing_outputs"] = self.missing
        reference.prefetch(i for _, gs in self.kept for g in gs for i in g)
        for (step, gs), kept in self.kept.items():
            c = self.checks[step]
            want = c.expected(reference, gs)
            for data in kept:
                got = c.parse(data) if isinstance(data, bytes) else data
                for key, n in c.compare(got, want, reference).items():
                    totals[key] += n
        return totals
