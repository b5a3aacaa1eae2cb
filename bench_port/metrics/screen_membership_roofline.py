"""Percent of the membership test's roofline in ``screen``: the least time
the card could take for the window's membership work over the device time
of the kernels inside the ``screen-membership`` spans of the port's
in-memory record (``torch.profiler``).

The least time is bytes over ``HBM_BYTES_PER_S`` (``harness/roofline.py``):
each reference hash and each of the query's distinct values read once (8
bytes each), and each hit (reference, query rank and multiplicity) and each
reference's shared count written once (8 bytes each), counted from the
spans' counters ``ref_hashes``, ``query_distinct`` and ``hits`` and the
``references`` of the job's ``screen-load``."""

from bench_port.harness.roofline import HBM_BYTES_PER_S
from bench_port.harness.tracing import union
from bench_port.metrics.msh_encode_share import window_spans
from bench_port.metrics.route_busy_pct import overlap_s


def membership_bytes(spans) -> int:
    """The bytes the membership tests of these spans read and write at least."""
    refs = {s.job: s.counters.get("references", 0) for s in spans if s.name == "screen-load"}
    return sum(8 * (c["ref_hashes"] + c["query_distinct"] + 3 * c["hits"] + refs.get(s.job, 0))
               for s in spans if s.name == "screen-membership" for c in [s.counters])


def read(run):
    spans = window_spans(run)
    if run.device is None or not spans:
        return None
    tests = union([(s.start, s.end) for s in spans if s.name == "screen-membership"])
    kernels = union([(s, e) for s, e, cat, _ in run.device.ops if cat == "kernel"])
    kernel_s = overlap_s(kernels, tests)
    if kernel_s <= 0:
        return None
    return 100.0 * membership_bytes(spans) / HBM_BYTES_PER_S / kernel_s
