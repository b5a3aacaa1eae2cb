"""The readers of the port's in-memory record (``metrics/msh_encode_share.py``,
``copy_bytes_per_base.py``, ``route_busy_pct.py``, ``setup_port_s.py``): known
answers on a made-up run and record, spans outside the window left out, and
None where the record is missing (as before the port kept one), empty, or
dropped spans."""

import json
import sys
from types import SimpleNamespace

import pytest

from bench_port.harness import runner, spec, tracing
from bench_port.tests.tiny import ROOT, TINY

TRACE = "fpmash_tpu_torch.utils.trace"
NEW = ("msh_encode_share", "copy_bytes_per_base", "route_busy_pct", "setup_port_s")


def _span(name, start, end, parent=1, **counters):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent, counters=counters)


#: set-up before 10, the window [10, 20], the reference check after it
SPANS = [
    _span("kernel-load", 1.0, 1.5, parent=None),
    _span("kernel-load", 2.5, 3.0),
    _span("command:sketch", 2.0, 4.0, parent=None),
    _span("msh-words", 3.0, 3.5),
    _span("factorize+hash", 3.5, 3.8, h2d_bytes=1000, d2h_bytes=1000),
    _span("command:sketch", 10.0, 20.0, parent=None),
    _span("factorize+hash", 11.0, 13.0, d2h_bytes=120),
    _span("factor-words", 11.0, 12.0, h2d_bytes=200),
    _span("msh-refs", 13.0, 14.0),
    _span("write-msh", 14.0, 17.0),
    _span("msh-words", 14.0, 15.5),
    _span("msh-pack", 15.5, 16.5),
    _span("msh-file", 16.5, 17.0),
    _span("factorize+hash", 18.0, 19.0, h2d_bytes=80),
    _span("factorize+hash", 25.0, 26.0, h2d_bytes=5000),
    _span("msh-pack", 27.0, 28.0),
]
DEVICE = tracing.DeviceTrace([(10.5, 11.5, "gpu_memcpy", "m"), (12.0, 12.5, "kernel", "k"),
                              (12.4, 12.6, "kernel", "k"), (18.5, 20.0, "gpu_memcpy", "m")])


def _run(device=DEVICE):
    return SimpleNamespace(t_open=10.0, t_close=20.0, window_s=10.0, bases=100, device=device)


def _record(monkeypatch, spans, dropped=0):
    monkeypatch.setitem(sys.modules, TRACE,
                        SimpleNamespace(spans=lambda: list(spans), dropped=lambda: dropped))


def _read(name, run):
    return spec.reader(name)(run)


def test_known_answers(monkeypatch):
    _record(monkeypatch, SPANS)
    run = _run()
    # msh-refs 1 s, msh-words 1.5 s and msh-pack 1 s of the window's 10 s
    assert _read("msh_encode_share", run) == pytest.approx(35.0)
    # 120 + 200 + 80 bytes over 100 bases
    assert _read("copy_bytes_per_base", run) == pytest.approx(4.0)
    # busy 0.5 + 0.6 of the route [11, 13] and 0.5 of [18, 19], over their 3 s
    assert _read("route_busy_pct", run) == pytest.approx(100.0 * 1.6 / 3.0)
    # the top-level spans before the window: kernel-load 0.5 s, the warm job 2 s
    assert _read("setup_port_s", run) == pytest.approx(2.5)


def test_spans_outside_the_window_are_left_out(monkeypatch):
    _record(monkeypatch, [s for s in SPANS if s.start >= 25.0 or s.end <= 10.0])
    run = _run()
    for name in ("msh_encode_share", "copy_bytes_per_base", "route_busy_pct"):
        assert _read(name, run) is None, name
    _record(monkeypatch, [s for s in SPANS if s.start >= 10.0])
    assert _read("setup_port_s", run) is None


def test_route_busy_needs_the_device_trace(monkeypatch):
    _record(monkeypatch, SPANS)
    assert _read("route_busy_pct", _run(device=None)) is None
    assert _read("route_busy_pct", _run(device=tracing.DeviceTrace([]))) == 0.0


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["missing", "no_record", "empty", "dropped"])
def test_no_record_reads_none(name, case, monkeypatch):
    if case == "missing":
        monkeypatch.delitem(sys.modules, TRACE, raising=False)
    elif case == "no_record":  # the port's trace before it kept spans: lines only
        monkeypatch.setitem(sys.modules, TRACE, SimpleNamespace(trace=lambda *a, **k: None))
    else:
        _record(monkeypatch, [] if case == "empty" else SPANS, dropped=case == "dropped")
    assert _read(name, _run()) is None


def test_entries_in_benchmark_json():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    want = {"msh_encode_share": ("%", "lower", "program_span", "Host models", "bases_per_s"),
            "copy_bytes_per_base": ("bytes/base", "lower", "program_counter", "Wrappers",
                                    "bases_per_s"),
            "route_busy_pct": ("%", "higher", "device_trace", "Wrappers", "bases_per_s"),
            "setup_port_s": ("s", "lower", "program_span", "CLI", "setup_s")}
    for name, fields in want.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == fields
        assert m["workloads"] == ["fp_cfl_sketch_reads", "fp_icflcomb_sketch_reads"]
    assert [m["name"] for m in bench["per_layer"][-4:]] == list(want)


def test_traced_run_reads_the_ports_record(tiny_cell):
    """A traced run on the CPU, at a tiny size, with the port's own record:
    every read of 300 bases hands across its stream (300 + 99 bytes), a
    start and a length a window (12 bytes), and gets back h1 and count (12)."""
    from fpmash_tpu_torch.utils import trace as port_trace

    was = port_trace.enabled()
    port_trace.clear()
    port_trace.enable(True)
    try:
        r = runner.run_cell(tiny_cell("fp_cfl_sketch_reads"), 2**31 + 17, 0.3, True,
                            device="cpu")
    finally:
        port_trace.enable(was)
        port_trace.clear()
    assert r["correct"] is True
    read_length = TINY["fp_cfl_sketch_reads"]["read_length"]
    per_base = (read_length + 99 + 24 * read_length) / read_length
    metrics = {k: v["value"] for k, v in r["metrics"].items()}
    assert metrics["copy_bytes_per_base"] == pytest.approx(per_base)
    assert 0 < metrics["msh_encode_share"] < 100
    assert metrics["setup_port_s"] > 0
    assert "route_busy_pct" not in metrics  # no device trace on the CPU
