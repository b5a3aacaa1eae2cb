"""Percent of the window in the device routes: uploads, launches, waits and
downloads of the ``classic-direct``, ``classic-direct-reads`` and
``factorize+hash`` spans (``ops/kmers*.py``, ``ops/fused_cuda.py``,
``ops/icfl_cuda.py``)."""

from bench_port.harness.layers import span_share


def read(run):
    return span_share(run, ("classic-direct", "classic-direct-reads", "factorize+hash"))
