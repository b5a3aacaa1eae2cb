"""Percent of the window in ``screen``'s query side: the union of the
``screen-query`` spans of the port's in-memory record (the read set parsed
and put on the device as one stream, its k-mers hashed and counted)."""

from bench_port.metrics.screen_load_share import share


def read(run):
    return share(run, "screen-query")
