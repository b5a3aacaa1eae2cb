"""Memory-bounded Bloom admission for reads mode (`sketch -b`); a copy of
:mod:`fpmash_tpu.ops.bloom`, host code in both packages.

Reproduces the reference's MinHashHeap bloom semantics
(mash/src/mash/MinHashHeap.cpp:19-41,78-95): with ``-b <mem>`` active, a
hash's FIRST occurrence only feeds the Bloom filter; its SECOND occurrence
(the filter now contains it) admits it to the sketch with multiplicity 2,
and later occurrences add 1 — so an admitted value's final count equals its
true occurrence count.  A Bloom false positive admits a single-copy hash on
first sight with count 2 (final count = occurrences + 1).  The memory bound
is the point: the filter is ``mem * 8`` bits regardless of stream size
(bloom_parameters maximum_size, MinHashHeap.cpp:28), trading false
positives for bounded memory on huge read sets.

At the reference's parameters (projected 1e9 elements against any
realistic ``-b`` size) the optimal probe count collapses to 1, so one
probe per value is the default here too.  Probe positions come from a
splitmix64 mix of the hash value — same false-positive *profile* class as
the reference's bloom, not bit-identical placement (documented deviation;
the reference's own admissions are approximate by design).

The stream is processed in chunks: each chunk is membership-tested against
all bits set by prior chunks, then inserted.  For the default single probe
the within-chunk ordering is also honored exactly (a probe position set by
an earlier value in the same chunk counts as a hit), so admission matches
the serial filter bit-for-bit.  With ``n_probes > 1`` within-chunk
collisions are ignored — a strictly-fewer-false-positives approximation.
"""

from __future__ import annotations

import numpy as np

_CHUNK = 1 << 16


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    return x ^ (x >> np.uint64(31))


def bloom_admit_counts(
    pool: np.ndarray, memory_bytes: int, n_probes: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Bloom-admit a hash stream; return (values, counts) of admitted
    distinct hashes, both in ascending hash order.

    ``pool`` is the k-mer hash stream in stream order.  Admitted = seen at
    least twice, or Bloom-false-positive on first sight; counts follow the
    reference's arithmetic (occurrences, +1 on a false-positive admission).
    """
    pool = np.asarray(pool, np.uint64)
    memory_bytes = max(int(memory_bytes), 8)
    m_bits = np.uint64(memory_bytes * 8)
    if len(pool) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)

    values, first_idx, counts = np.unique(
        pool, return_index=True, return_counts=True
    )
    order = np.argsort(first_idx, kind="stable")  # stream order of first sight
    v_stream = values[order]
    c_stream = counts[order]

    words = np.zeros((int(m_bits) + 63) // 64, np.uint64)
    fp = np.zeros(len(v_stream), bool)
    for lo in range(0, len(v_stream), _CHUNK):
        chunk = v_stream[lo : lo + _CHUNK]
        hit = np.ones(len(chunk), bool)
        positions = []
        x = chunk
        for _ in range(n_probes):
            x = _splitmix64(x)
            pos = x % m_bits
            positions.append(pos)
            hit &= (words[(pos >> np.uint64(6)).astype(np.int64)]
                    >> (pos & np.uint64(63))) & np.uint64(1) == 1
        if n_probes == 1:
            # serial-exact: a position set by an EARLIER value of this same
            # chunk is a hit for later values
            pos = positions[0]
            order = np.argsort(pos, kind="stable")
            ps = pos[order]
            dup_sorted = np.concatenate([[False], ps[1:] == ps[:-1]])
            dup = np.zeros(len(chunk), bool)
            dup[order] = dup_sorted
            hit |= dup
        fp[lo : lo + _CHUNK] = hit
        for pos in positions:
            np.bitwise_or.at(
                words,
                (pos >> np.uint64(6)).astype(np.int64),
                np.uint64(1) << (pos & np.uint64(63)),
            )
    admitted = (c_stream >= 2) | fp
    out_vals = v_stream[admitted]
    out_counts = (c_stream[admitted] + fp[admitted]).astype(np.uint32)
    asc = np.argsort(out_vals, kind="stable")
    return out_vals[asc], out_counts[asc]
