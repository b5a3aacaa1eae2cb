"""A ``.msh`` sketch file, read by the frozen reader (``reference/msh.py``),
against the reference's entries of the step's inputs, in order.

* ``wrong_fields``: header fields, sketch entries, names, comments and
  lengths that differ;
* ``wrong_hashes``: hash positions that differ (a missing or extra hash
  counts);
* ``wrong_counts``: k-mer counts that differ, where the sketch keeps them.

The sketches are exact, so each limit is 0.
"""

import numpy as np

from bench_port.reference.msh import Msh, MshRef, read_msh

LIMITS = {"wrong_fields": 0, "wrong_hashes": 0, "wrong_counts": 0}


def parse(data: bytes) -> Msh:
    return read_msh(data)


def expected(reference, groups) -> list:
    return [w for g in groups for idx in g for w in reference.entries(idx)]


def render(want: list, reference) -> Msh:
    h = reference.header
    m = Msh(kmer=h["kmer"], window=0, sketch_size=h["sketch_size"], concatenated=True,
            noncanonical=h["noncanonical"], preserve_case=False, error=0.0, seed=h["seed"],
            alphabet=h["alphabet"])
    m.refs = [MshRef(w.name, w.comment, w.length, w.hashes, w.counts, w.counts is not None)
              for w in want]
    return m


def _diff(a: list, b: list) -> int:
    n = min(len(a), len(b))
    x = np.asarray(a[:n], np.uint64)
    y = np.asarray(b[:n], np.uint64)
    return int((x != y).sum()) + abs(len(a) - len(b))


def compare(got: Msh, want: list, reference) -> dict:
    wrong = dict.fromkeys(LIMITS, 0)
    h = reference.header
    seen = {"kmer": got.kmer, "sketch_size": got.sketch_size, "seed": got.seed,
            "alphabet": got.alphabet, "noncanonical": got.noncanonical,
            "hash_bits": got.hash_bits}
    wrong["wrong_fields"] += sum(seen[key] != h[key] for key in seen)
    wrong["wrong_fields"] += abs(len(want) - len(got.refs))
    for w, g in zip(want, got.refs):
        wrong["wrong_fields"] += (w.name != g.name) + (w.comment != g.comment) + (
            w.length != g.length)
        wrong["wrong_hashes"] += _diff(w.hashes, g.hashes)
        if w.counts is not None or g.counts is not None:
            wrong["wrong_counts"] += _diff(w.counts or [], g.counts or [])
    return wrong
