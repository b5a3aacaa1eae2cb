"""Percent of the window spent reading the inputs: the ``read-sequences``
(FASTA/FASTQ, classic sketches) and ``read-fasta`` (``--direct-fp``) spans."""

from bench_port.harness.layers import span_share


def read(run):
    return span_share(run, ("read-sequences", "read-fasta"))
