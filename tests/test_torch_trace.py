"""Port: the stage tracer (``utils/trace.py``) and the byte counters of the
copies between host and device (``device.to_device``/``to_host``).

The record keeps every span with its start, end, parent, job, attributes and
counters; the stderr line keeps its text; off, nothing is kept or printed.
The counters are held to the ``nbytes`` of what ``sketch --direct-fp``'s
routes hand across, on the CPU, where the copies are the same calls."""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models import fingerprint
from fpmash_tpu_torch.models.fingerprint import window_stream
from fpmash_tpu_torch.models.sketch import sketch_from_arrays
from fpmash_tpu_torch.ops import _build
from fpmash_tpu_torch.device import to_device, to_host
from fpmash_tpu_torch.utils import trace as trace_mod
from fpmash_tpu_torch.utils.msh import MshFile, MshReference, read_msh, write_msh
from fpmash_tpu_torch.utils.trace import count, trace

CPU = torch.device("cpu")
READS = [("R0", 150), ("R1", 120), ("R2", 60)]  # the last one window of itself


@pytest.fixture
def traced():
    """Tracing on over an empty record; the switch as it was afterwards."""
    was = trace_mod.enabled()
    trace_mod.clear()
    trace_mod.enable(True)
    yield trace_mod
    trace_mod.enable(was)
    trace_mod.clear()


@pytest.fixture
def untraced():
    was = trace_mod.enabled()
    trace_mod.clear()
    trace_mod.enable(False)
    yield trace_mod
    trace_mod.enable(was)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(19)
    path = tmp_path_factory.mktemp("trace") / "reads.fa"
    seqs = {}
    with open(path, "w") as fh:
        for name, n in READS:
            seqs[name] = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
            fh.write(f">{name}\n{seqs[name]}\n")
    return path, seqs


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_start_end_parent_and_job(traced, capsys):
    with trace("setup"):
        pass
    with trace("command:sketch") as cmd:
        with trace("read", files=1) as read:
            with trace("inner"):
                pass
        with trace("write"):
            pass
    spans = _by_name(traced.spans())
    assert [s.name for s in traced.spans()] == ["setup", "inner", "read", "write",
                                                "command:sketch"]
    assert spans["setup"][0].parent is None and spans["setup"][0].job is None
    assert cmd.parent is None and cmd.job == cmd.id
    assert read.parent == cmd.id and read.job == cmd.id and read.extra == {"files": 1}
    inner = spans["inner"][0]
    assert inner.parent == read.id and inner.job == cmd.id
    assert spans["write"][0].parent == cmd.id
    for s in traced.spans():
        assert s.start <= s.end
    assert cmd.start <= read.start <= inner.start <= inner.end <= read.end <= cmd.end
    assert len({s.id for s in traced.spans()}) == 5
    assert len(capsys.readouterr().err.splitlines()) == 5


def test_the_outermost_command_names_the_job(traced):
    with trace("command:dist") as outer:
        with trace("command:sketch") as nested:
            pass
    assert nested.job == outer.job == outer.id


def test_a_generators_span_may_close_after_its_callers(traced):
    def pairs():
        with trace("pair-results"):
            yield 1
            yield 2

    with trace("command:dist") as cmd:
        it = pairs()
        next(it)
        with trace("format-lines") as inner:
            pass
        it.close()
        with trace("after") as after:
            pass
    gen = _by_name(traced.spans())["pair-results"][0]
    assert gen.parent == cmd.id and inner.parent == gen.id and after.parent == cmd.id


def test_stderr_line_keeps_its_text(traced, capsys, monkeypatch):
    clock = iter([10.0, 11.25, 20.0, 20.5, 30.0, 30.0004])
    monkeypatch.setattr(trace_mod.time, "perf_counter", lambda: next(clock))
    with trace("factorize+hash", windows=512000, shards=1):
        pass
    with trace("command:sketch"):
        pass
    with trace("msh-file", bytes=7):
        pass
    assert capsys.readouterr().err.splitlines() == [
        "[fpmash] factorize+hash: 1.250s  windows=512000  shards=1",
        "[fpmash] command:sketch: 0.500s",
        "[fpmash] msh-file: 0.000s  bytes=7",
    ]
    assert [(s.start, s.end) for s in traced.spans()] == [(10.0, 11.25), (20.0, 20.5),
                                                          (30.0, 30.0004)]


def test_off_keeps_and_prints_nothing_and_enable_switches_at_run_time(untraced, capsys):
    assert trace("a", x=1) is trace("b")  # one shared no-op
    with trace("a", x=1):
        count("h2d_bytes", 8)
    assert untraced.spans() == [] and capsys.readouterr().err == ""
    untraced.enable(True)
    assert untraced.enabled()
    with trace("b"):
        count("h2d_bytes", 8)
    untraced.enable(False)
    with trace("c"):
        pass
    assert [(s.name, s.counters) for s in untraced.spans()] == [("b", {"h2d_bytes": 8})]
    assert capsys.readouterr().err == "[fpmash] b: 0.000s\n"
    untraced.clear()


def test_count_adds_to_the_innermost_open_span(traced):
    count("h2d_bytes", 5)  # no span open: nothing to add to
    with trace("outer") as outer:
        count("h2d_bytes", 1)
        with trace("inner") as inner:
            count("h2d_bytes", 2)
            count("h2d_bytes", 3)
            count("d2h_bytes", 4)
    assert outer.counters == {"h2d_bytes": 1}
    assert inner.counters == {"h2d_bytes": 5, "d2h_bytes": 4}


def test_the_record_is_capped_and_counts_what_it_drops(traced, monkeypatch):
    monkeypatch.setattr(trace_mod, "CAP", 2)
    for name in "abc":
        with trace(name):
            pass
    assert [s.name for s in traced.spans()] == ["a", "b"] and traced.dropped() == 1
    traced.clear()
    assert traced.spans() == [] and traced.dropped() == 0


def test_copy_helpers_count_what_crosses(traced):
    host = np.arange(10, dtype=np.uint64)
    with trace("route") as route:
        dev = to_device(host, CPU)
        to_device(np.arange(6, dtype=np.int32)[::2], CPU)  # made contiguous: 3 values
        back = to_host(dev[:4])
        to_device(dev, CPU)  # already on the host: counted as handed across
    assert dev.dtype == torch.int64 and back.tolist() == [0, 1, 2, 3]
    assert route.counters == {"h2d_bytes": 80 + 12 + 80, "d2h_bytes": 32}


def test_kernel_load_span_names_the_library(traced):
    _build.host_library("fpio")  # builds it where this checkout has not yet
    traced.clear()
    _build.host_library.__wrapped__("fpio")  # a first load in a process, of a build there
    (span,) = [s for s in traced.spans() if s.name == "kernel-load"]
    assert span.extra == {"lib": "fpio", "built": False}


def _sketch(fasta, tmp_path, out, family):
    argv = ["sketch", "--direct-fp", str(fasta), "-o", str(tmp_path / out), "--device", "cpu"]
    if family != "CFL":
        argv[2:2] = ["--factorization", family]
    assert port_main(argv) == 0
    return (tmp_path / f"{out}.msh").read_bytes()


@pytest.mark.parametrize("family", ["CFL", "ICFL_COMB"])
def test_sketch_direct_fp_counts_its_copies_and_splits_write_msh(fasta, tmp_path, family,
                                                                 untraced, capsys):
    path, seqs = fasta
    off = _sketch(path, tmp_path, "off", family)
    assert untraced.spans() == [] and "[fpmash]" not in capsys.readouterr().err

    rows_before = dict(fingerprint.SCALAR_ROWS)
    untraced.enable(True)
    try:
        on = _sketch(path, tmp_path, "on", family)
    finally:
        untraced.enable(False)
    assert on == off
    assert fingerprint.SCALAR_ROWS == rows_before  # every window on the device route

    spans = untraced.spans()
    by = _by_name(spans)
    (cmd,) = by["command:sketch"]
    assert all(s.job == cmd.id for s in spans)
    flat, starts, lengths, _ = window_stream([seqs[n] for n, _ in READS], shift=True)
    windows = len(starts)
    assert windows == 150 + 120 + 1
    h1 = np.zeros(windows, np.int64)
    cnt = np.zeros(windows, np.int32)
    if family == "CFL":  # the stream, a start and a length a window up; h1 and count down
        up, down = flat.nbytes + starts.nbytes + lengths.nbytes, h1.nbytes + cnt.nbytes
    else:  # factor_words' stream, starts and lengths, and ok down; hash_words' row index up
        rows = np.arange(windows, dtype=np.int64)
        ok = np.ones(windows, bool)
        up = flat.nbytes + starts.nbytes + lengths.nbytes + rows.nbytes
        down = ok.nbytes + h1.nbytes + cnt.nbytes
    assert sum(s.counters.get("h2d_bytes", 0) for s in spans) == up
    assert sum(s.counters.get("d2h_bytes", 0) for s in spans) == down
    (route,) = by["factorize+hash"]
    inside = [s for s in spans if s.parent == route.id] + [route]
    assert sum(sum(s.counters.values()) for s in inside) == up + down

    (write,) = by["write-msh"]
    assert [s.name for s in spans if s.parent == write.id] == ["msh-words", "msh-pack",
                                                                "msh-file"]
    (words,) = by["msh-words"]
    assert 8 * (words.counters["words"] + 1) == len(on)  # the stream header, then the words
    # copied in whole arrays: each reference's hashes, name and comment, and the alphabet
    m = read_msh(str(tmp_path / "on.msh"))
    lists = [(len(r.hashes32) + 1) // 2 for r in m.references] + [
        _text_words(t) for r in m.references for t in (r.name, r.comment)]
    assert words.counters == {"words": words.counters["words"],
                              "bulk_words": sum(lists) + _text_words(m.alphabet)}
    (refs,) = by["msh-refs"]
    assert refs.parent == write.parent == cmd.id and refs.end <= write.start
    assert by["msh-file"][0].extra == {"bytes": len(on)}
    untraced.clear()


def _text_words(text):
    return (len(text.encode()) + 8) // 8  # and its NUL


def test_write_msh_copies_a_job_sized_message_in_whole_arrays(traced, tmp_path):
    rng = np.random.default_rng(20)
    m = MshFile(kmer_size=1, alphabet="0123456789", references=[
        MshReference(name=f"read_{i}", comment="", length=2000,
                     hashes32=np.sort(rng.integers(0, 2**32, 2000, dtype=np.uint64)).astype(
                         np.uint32))
        for i in range(256)])  # a fingerprint job's sketch: 256 reads of 2 000 bases
    with trace("write-msh") as write:
        write_msh(str(tmp_path / "job.msh"), m)
    spans = traced.spans()
    assert [s.name for s in spans if s.parent == write.id] == ["msh-words", "msh-pack",
                                                                "msh-file"]
    (words,) = _by_name(spans)["msh-words"]
    assert 8 * (words.counters["words"] + 1) == (tmp_path / "job.msh").stat().st_size
    assert words.counters["bulk_words"] >= 0.95 * words.counters["words"]


def _write_msh(path, rng, n):
    sketch_from_arrays(dict(kmer_size=21, sketch_size=64),
                       [dict(name=f"s{i}", comment="", length=5000,
                             hashes=np.unique(rng.integers(0, 2**64, 40, dtype=np.uint64)))
                        for i in range(n)]).write_msh(str(path))
    return str(path)


def test_dist_and_triangle_trace_pairs_and_lines_once_a_call(tmp_path, traced, capsys):
    rng = np.random.default_rng(5)
    ref, qry = _write_msh(tmp_path / "r.msh", rng, 4), _write_msh(tmp_path / "q.msh", rng, 3)
    assert port_main(["dist", ref, qry, "--device", "cpu"]) == 0
    by = _by_name(traced.spans())
    (pairs,) = by["pair-results"]
    (dist,) = by["distances"]
    assert pairs.parent == dist.id and pairs.extra == {"pairs": 12}
    assert by["format-lines"][0].extra == {"pairs": 12}
    assert len(capsys.readouterr().out.splitlines()) == 12
    traced.clear()
    assert port_main(["triangle", ref, "--device", "cpu"]) == 0
    (lines,) = _by_name(traced.spans())["format-lines"]
    assert lines.extra == {"pairs": 6}


def test_reads_route_traces_records_and_blob(tmp_path, traced):
    rng = np.random.default_rng(8)
    fq = tmp_path / "r.fq"
    with open(fq, "w") as fh:
        for i in range(30):
            seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 100)].tobytes().decode()
            fh.write(f"@q{i}\n{seq}\n+\n{'I' * 100}\n")
    assert port_main(["sketch", "-r", str(fq), "-o", str(tmp_path / "r"), "--device",
                      "cpu"]) == 0
    by = _by_name(traced.spans())
    (records,) = by["records"]
    assert records.extra == {"records": 30}
    assert by["blob"] and all(s.extra == {"records": 30} for s in by["blob"])
    assert sum(s.counters.get("d2h_bytes", 0) for s in traced.spans()) > 0
