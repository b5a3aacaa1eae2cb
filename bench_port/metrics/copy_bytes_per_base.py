"""Bytes copied between host and card an input base: the ``h2d_bytes`` and
``d2h_bytes`` counters of the window's spans in the port's in-memory record
(``utils/trace.py``; counted by ``parallel/sharded.to_device`` and
``to_host``, which every copy of ``sketch``'s routes goes through), over the
window's input bases."""

from bench_port.metrics.msh_encode_share import window_spans

COUNTERS = ("h2d_bytes", "d2h_bytes")


def read(run):
    spans = window_spans(run)
    if not spans or not run.bases:
        return None
    return sum(s.counters.get(c, 0) for s in spans for c in COUNTERS) / run.bases
