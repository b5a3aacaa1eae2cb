"""The traced run's arithmetic: stamped span lines, device busy time, and
idle time by the innermost span open at the time."""

import pytest

from bench_port.harness import layers, tracing


def test_stamped_lines_make_spans(monkeypatch):
    clock = iter([10.0, 10.0, 12.5, 12.5, 13.0, 13.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(clock))
    out = tracing.StampedLines()
    print("[fpmash] read-sequences: 1.250s  files=1  reader=native", file=out)
    print("Writing to out.msh...", file=out)
    print("[fpmash] command:sketch: 3.000s", file=out)
    assert out.spans() == [tracing.Span("read-sequences", 8.75, 10.0),
                           tracing.Span("command:sketch", 10.0, 13.0)]


def test_idle_goes_to_the_innermost_span():
    # the parent's start, rounded to the millisecond, falls after its child's
    spans = [tracing.Span("read-sequences", 0.0045, 1.6245),
             tracing.Span("classic-direct-reads", 2.3, 2.4),
             tracing.Span("command:sketch", 0.0046, 2.6)]
    trace = tracing.DeviceTrace([(2.32, 2.33, "kernel", "k"), (2.35, 2.36, "gpu_memcpy", "m")])
    b = tracing.breakdown(trace, spans, 0.0, 3.0)
    gaps = dict(b["idle_gaps"])
    assert gaps["read-sequences"] == pytest.approx(1.62)
    assert gaps["classic-direct-reads"] == pytest.approx(0.08)
    assert gaps["command:sketch"] == pytest.approx(2.6 - 1.6245 - 0.1)
    assert gaps["between_spans"] == pytest.approx(0.4 + 0.0045)
    assert dict(b["device_ops"]) == pytest.approx({"k": 0.01, "m": 0.01})
    assert trace.busy_s() == pytest.approx(0.02) and trace.kernel_s() == pytest.approx(0.01)


def test_span_share_counts_overlaps_once():
    class Run:
        window_s = 10.0
        spans = [tracing.Span("write-msh", 1, 3), tracing.Span("write-msh", 2, 4),
                 tracing.Span("other", 0, 10)]

    assert layers.span_share(Run, ("write-msh",)) == pytest.approx(30.0)
    assert layers.span_share(Run, ("read-fasta",)) is None
