"""Percent of the window in the ``.msh`` encoder: the union of the
``msh-refs`` (``models/sketch.py``, the references made into the file's),
``msh-words`` and ``msh-pack`` (``utils/msh.py``, the message's words and
their bytes) spans of the port's in-memory record (``utils/trace.py``),
over the window; ``msh-file``, the write itself, is left out.

:func:`record` and :func:`window_spans` serve the other readers of the record too."""

import sys

from bench_port.harness.tracing import union

NAMES = ("msh-refs", "msh-words", "msh-pack")


def record():
    """The spans the port's ``utils/trace.py`` kept in this process, or None
    where it keeps no record (as before it kept spans), kept none, or dropped some."""
    trace = sys.modules.get("fpmash_tpu_torch.utils.trace")
    if not hasattr(trace, "spans") or trace.dropped():
        return None
    return trace.spans() or None


def window_spans(run):
    """The record's spans that lie inside the window (None as :func:`record`)."""
    spans = record()
    if spans is None:
        return None
    return [s for s in spans if run.t_open <= s.start and s.end <= run.t_close]


def read(run):
    encode = union([(s.start, s.end) for s in window_spans(run) or () if s.name in NAMES])
    if not encode:
        return None
    return 100.0 * sum(e - s for s, e in encode) / run.window_s
