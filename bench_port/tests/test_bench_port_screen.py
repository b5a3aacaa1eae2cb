"""The screen cell, ``refseq_screen_metagenome``, built tiny from its files: a
run is correct and reads its spans, its control is not correct, the check
catches an altered identity, median and shared count, the generator's
database reads back through the frozen ``.msh`` reader, and a warm job past
the generator's limit stops the run."""

import gc
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bench_port import control
from bench_port.harness import runner, spec, traffic
from bench_port.reference.msh import read_msh
from bench_port.tests.tiny import ROOT

NAME = "refseq_screen_metagenome"
TINY = {"references": 200, "genomes": 8, "family_size": 4, "genome_length": 20000,
        "distractor_length": [100000, 1000000], "read_sets": 2, "reads": 3000, "present": 3}


def _cell():
    cell = spec.load_cell(NAME)
    cell.traffic["params"].update(TINY)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(trace, monkeypatch):
    from fpmash_tpu_torch.utils import trace as port_trace

    monkeypatch.setattr(port_trace, "_ENABLED", trace)
    r = runner.run_cell(_cell(), 2**31 + 21, 0.2, trace, device="cpu")
    assert r.pop("_failures") == []
    assert r["correct"] is True and r["attempted"] >= 1, r["check"]
    assert set(r["check"]) == {"missing_outputs", "wrong_lines"}
    if trace:  # the span readers find spans; the roofline finds no device trace here
        assert {"screen_load_share", "screen_query_share"} <= set(r["metrics"])
        assert "screen_membership_roofline" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"bases_per_s", "setup_s"}


def test_control_is_not_correct():
    r = control.control(_cell(), 2**31 + 5, 2, "cpu")
    assert r["correct"] is False and r["check"]["wrong_lines"] > 0


def _drop_a_hash(found):
    """The membership test's results with one shared hash missed by every reference."""
    shared, rid, rank, depth, smallest = found
    keep = rank != rank[0]
    return shared, rid[keep], rank[keep], depth[keep], smallest


@pytest.mark.parametrize("fault", ["identity", "median", "shared"])
def test_altered_lines_are_not_correct(fault, monkeypatch):
    from fpmash_tpu_torch.commands import screen_cmd

    if fault == "identity":
        ident = screen_cmd.estimate_identity
        monkeypatch.setattr(screen_cmd, "estimate_identity",
                            lambda c, d, k: ident(c, d, k) * (1 - 1e-4))
    elif fault == "median":
        medians = screen_cmd._medians
        monkeypatch.setattr(screen_cmd, "_medians", lambda *a: medians(*a) + 1)
    else:
        membership = screen_cmd._membership
        monkeypatch.setattr(screen_cmd, "_membership", lambda *a: _drop_a_hash(membership(*a)))
    r = runner.run_cell(_cell(), 2**31 + 23, 0.2, False, device="cpu")
    assert r["correct"] is False
    assert r["check"]["wrong_lines"]["value"] >= 1


def test_generated_database_reads_back_through_the_frozen_reader(tmp_path):
    cell = _cell()
    pool, _ = traffic.make_pool(cell.traffic, 2**31 + 7, tmp_path)
    db = pool.items[0]
    m = read_msh(db.path.read_bytes())
    cfg = cell.config
    assert (m.kmer, m.sketch_size, m.seed, m.alphabet, m.noncanonical, m.hash_bits) == (
        cfg["kmer"], cfg["sketch_size"], cfg["hash_seed"], cfg["alphabet"],
        not cfg["canonical"], cfg["hash_bits"])
    assert [r.name for r in m.refs] == db.headers
    assert [r.comment for r in m.refs] == db.comments
    assert [r.length for r in m.refs] == db.lengths.tolist()
    assert [len(r.hashes) for r in m.refs] == db.seg_len.tolist()
    assert np.array_equal(np.concatenate([np.asarray(r.hashes, np.uint64) for r in m.refs]),
                          db.hashes)
    assert sum("genome" in c for c in db.comments) == TINY["genomes"]
    assert all(np.all(np.diff(np.asarray(r.hashes, np.uint64)) > 0) for r in m.refs)


def _alarm_off():
    return signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0) and \
        signal.getsignal(signal.SIGALRM) == signal.SIG_DFL


def test_warm_job_alarm_stops_at_the_second_draw():
    metagenome = spec.module("generators", "metagenome")
    pool = metagenome.ScreenPool([None] * 3, 2)
    draws = pool.jobs(np.random.default_rng(1))
    assert next(draws)[0] == 0
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= metagenome.WARM_LIMIT_S
    assert [next(draws)[1] for _ in range(4)] and _alarm_off()
    draws.close()
    assert _alarm_off()


def test_warm_job_past_the_limit_stops_the_run(monkeypatch):
    """A program whose warm job outlasts ``WARM_LIMIT_S`` ends the run with
    ``SlowWarmJob`` before the window, instead of counting a failed job."""
    load = spec.module

    def module(kind, name, root=spec.ROOT):
        mod = load(kind, name, root)
        if kind == "generators":
            mod.WARM_LIMIT_S = 0.5
            module.generator = mod
        return mod

    step = runner.ProgramStep.__call__

    def slow_step(self, argv, keep_stdout):
        time.sleep(5.0)
        return step(self, argv, keep_stdout)

    monkeypatch.setattr(spec, "module", module)
    monkeypatch.setattr(runner.ProgramStep, "__call__", slow_step)
    t0 = time.perf_counter()
    with pytest.raises(BaseException) as caught:
        runner.run_cell(_cell(), 2**31 + 29, 0.2, False, device="cpu")
    assert type(caught.value) is module.generator.SlowWarmJob
    assert time.perf_counter() - t0 < 60
    del caught
    gc.collect()
    assert _alarm_off()


def test_warm_job_held_in_c_ends_the_process(tmp_path):
    """Where the alarm cannot reach Python (here it is blocked, as a long C
    call holds it off), ``faulthandler`` ends the process with status 1."""
    code = ("import signal, sys, time; sys.path.insert(0, %r)\n"
            "import numpy as np\n"
            "from bench_port.harness import spec\n"
            "m = spec.module('generators', 'metagenome')\n"
            "m.WARM_LIMIT_S, m.HARD_GRACE_S = 0.2, 0.3\n"
            "draws = m.ScreenPool([None] * 3, 2).jobs(np.random.default_rng(1))\n"
            "next(draws)\n"
            "signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})\n"
            "time.sleep(30)\n"
            "print('not stopped')\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 1, out.stderr
    assert "Timeout" in out.stderr and "not stopped" not in out.stdout
