"""Arithmetic that the per-layer readers share: span time over the window,
and the work a window's jobs held, counted from their inputs."""

from __future__ import annotations

from bench_port.harness.tracing import union


def span_share(run, names) -> float | None:
    """Percent of the window spent in spans of these names (None if none ran)."""
    spans = [s for s in run.spans if s.name in names]
    if not spans:
        return None
    return 100.0 * sum(e - s for s, e in union([(s.start, s.end) for s in spans])) \
        / run.window_s


def item_indices(run) -> list[int]:
    """The pool index of every input of every job in the window."""
    return [i for job in run.jobs for i in job]


def items(run):
    """The pool item of every input of every job in the window."""
    return [run.pool.items[i] for i in item_indices(run)]


def kmer_positions(run, k: int) -> int:
    """Windows of ``k`` letters in the window's inputs."""
    n = 0
    for item in items(run):
        for seq in item.seqs:
            rows, length = (seq.shape if seq.ndim == 2 else (1, seq.shape[0]))
            n += rows * max(0, length - k + 1)
    return n


def shift_windows(run, width: int = 100) -> tuple[int, int, int]:
    """``(stream bytes, windows, letters)`` of the window's reads cut into
    cyclic windows of ``width`` (a shorter read is one window of itself)."""
    stream = windows = chars = 0
    for item in items(run):
        for seq in item.seqs:
            n = len(seq)
            if n >= width:
                stream, windows, chars = stream + n + width - 1, windows + n, chars + n * width
            else:
                stream, windows, chars = stream + n, windows + 1, chars + n
    return stream, windows, chars
