"""Percent of the window in ``screen``'s load of the sketch database: the
union of the ``screen-load`` spans of the port's in-memory record
(``utils/trace.py``; reading and adopting the ``.msh``, its hashes made one
CSR array and put on the device, their distinct count) over the window.

:func:`share` serves ``screen_query_share`` too."""

from bench_port.harness.tracing import union
from bench_port.metrics.msh_encode_share import window_spans


def share(run, name: str):
    """Percent of the window in the union of the record's ``name`` spans
    (None where the record has none, as before the port kept them)."""
    spans = union([(s.start, s.end) for s in window_spans(run) or () if s.name == name])
    if not spans:
        return None
    return 100.0 * sum(e - s for s, e in spans) / run.window_s


def read(run):
    return share(run, "screen-load")
