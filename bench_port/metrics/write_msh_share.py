"""Percent of the window spent writing ``.msh`` files (``write-msh`` spans,
``utils/msh.py``)."""

from bench_port.harness.layers import span_share


def read(run):
    return span_share(run, ("write-msh",))
