"""Percent of the device routes' time in which the card is busy: the union
of the traced window's kernels, copies and fills (``torch.profiler``)
inside the ``factorize+hash``, ``classic-direct`` and ``classic-direct-reads``
spans of the port's in-memory record (``utils/trace.py``), over those spans'
time.  The rest is the host's work around the kernels: allocations, waits,
and the copies' host side."""

from bench_port.harness.tracing import union
from bench_port.metrics.msh_encode_share import window_spans

ROUTES = ("factorize+hash", "classic-direct", "classic-direct-reads")


def overlap_s(a, b) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(run):
    if run.device is None:
        return None
    routes = union([(s.start, s.end) for s in window_spans(run) or () if s.name in ROUTES])
    if not routes:
        return None
    return 100.0 * overlap_s(run.device.busy(), routes) / sum(e - s for s, e in routes)
