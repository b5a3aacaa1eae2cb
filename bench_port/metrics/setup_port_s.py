"""Seconds of set-up in the port's own spans: the top-level spans of the
port's in-memory record (``utils/trace.py``) that end before the window
opens, the warm job's ``command:*`` span and any ``kernel-load`` outside
it.  The rest of ``setup_s`` is the interpreter, ``torch``'s import and the
harness's own work (the inputs made from the seed)."""

from bench_port.metrics.msh_encode_share import record


def read(run):
    before = [s.end - s.start for s in record() or () if s.parent is None and s.end < run.t_open]
    return sum(before) if before else None
