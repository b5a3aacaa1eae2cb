"""A run prints its result as the last line, on the CPU at a tiny size; on a
machine with no card the command fails and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from bench_port.harness import runner
from bench_port.tests.tiny import ROOT, TINY

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_run_prints_result_on_cpu(name, trace, tiny_cell, monkeypatch):
    from fpmash_tpu_torch.utils import trace as port_trace

    monkeypatch.setattr(port_trace, "_ENABLED", trace)
    cell = tiny_cell(name)
    r = runner.run_cell(cell, 2**31 + 99, 0.3, trace, device="cpu")
    assert r.pop("_failures") == []
    r.pop("_notes")
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["check"]) == {"missing_outputs", "wrong_fields", "wrong_hashes", "wrong_counts"}
    want = cell.end_to_end if not trace else []
    assert set(r["metrics"]) >= {m["name"] for m in want}
    if trace:  # the span readers find spans; the device readers find no trace here
        assert "cli_self_share" in r["metrics"] and "device_idle_pct" not in r["metrics"]
    json.dumps(r)


def test_no_card_fails_without_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                           "fp_cfl_sketch_reads", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_percentile_interpolates():
    assert runner.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    assert runner.percentile([7.0], 95) == 7.0


def test_without_the_port_it_fails(tmp_path):
    """A directory with only BENCHMARK.json and bench_port/ prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, runpy; sys.argv = ['run.py', '--workload', "
                           "'fp_cfl_sketch_reads', '--seed', '3', '--seconds', '1']; "
                           "import torch; torch.cuda.is_available = lambda: True; "
                           "torch.cuda.device_count = lambda: 1; "
                           "runpy.run_path('bench_port/run.py', run_name='__main__')"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
