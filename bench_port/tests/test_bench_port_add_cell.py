"""A cell is added from files alone: a traffic file, a workload entry and a
per-layer reader, with no edit to a file that is there.  One such cell is
the CFL_COMB sketch, another fp-mash family; the other is fp-mash's README workflow, a job of three
steps (two ``sketch --direct-fp`` and a ``dist -fp`` of their sketches),
whose sketches and distance lines are both checked."""

import json
import shutil

import pytest

from bench_port.harness import runner, spec
from bench_port.tests.tiny import ROOT

_SKETCH_FP = ["sketch", "--direct-fp", "--factorization", "{factorization}", "--rev-comb",
              "{rev_comb}", "-S", "{hash_seed}"]
_READS = {"pool": 3, "reads": 3, "read_length": 150, "gc": 0.6, "line_width": 70}

NEW_CELLS = {
    "fp_cflcomb_sketch_reads": {
        "generator": "fp_reads",
        "params": _READS,
        "steps": [{"argv": _SKETCH_FP + ["-o", "{dir}/out", "{inputs}", "--device", "{device}"],
                   "output": "out.msh", "check": "msh"}],
        "expect": {"factorization": "CFL_COMB"},
    },
    "fp_cfl_workflow_reads": {
        "generator": "fp_reads",
        "params": {**_READS, "inputs_per_job": 2},
        "steps": [
            {"argv": _SKETCH_FP + ["-o", "{dir}/a", "{inputs[0]}", "--device", "{device}"],
             "output": "a.msh", "check": "msh", "inputs": [[0]]},
            {"argv": _SKETCH_FP + ["-o", "{dir}/b", "{inputs[1]}", "--device", "{device}"],
             "output": "b.msh", "check": "msh", "inputs": [[1]]},
            {"argv": ["dist", "-fp", "{dir}/a.msh", "{dir}/b.msh", "--device", "{device}"],
             "output": "-", "check": "dist_lines", "inputs": [[0], [1]]},
        ],
        "expect": {"factorization": "CFL"},
    },
}


def _add(tmp_path, name):
    """A copy of the benchmark with the cell ``name`` added as new files and
    entries; returns the copy's files as they were before the run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    (tmp_path / "bench_port" / "traffic" / f"{name}.json").write_text(
        json.dumps(NEW_CELLS[name]))
    (tmp_path / "bench_port" / "metrics" / f"jobs_in_{name}.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "fpmash-2kb-reads", "traffic": name,
                               "chips": 1, "why": "a cell added as data"})
    bench["per_layer"].append({"name": f"jobs_in_{name}", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "CLI", "moves": "bases_per_s",
                               "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_cell_from_files_alone(name, tmp_path, monkeypatch):
    from fpmash_tpu_torch.utils import trace as port_trace

    before = _add(tmp_path, name)
    cell = spec.load_cell(name, tmp_path)
    for trace in (False, True):
        monkeypatch.setattr(port_trace, "_ENABLED", trace)
        r = runner.run_cell(cell, 2**31 + 3, 0.2, trace, device="cpu")
        assert r.pop("_failures") == []
        assert r["correct"] is True, r["check"]
        if trace:
            assert r["metrics"][f"jobs_in_{name}"]["value"] == r["attempted"]
        else:
            assert {"bases_per_s", "setup_s"} <= set(r["metrics"])
    if name == "fp_cfl_workflow_reads":
        assert set(r["check"]) == {"missing_outputs", "wrong_fields", "wrong_hashes",
                                   "wrong_counts", "wrong_pairs"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_workflow_cell_fails_an_altered_distance(tmp_path, monkeypatch):
    """The workflow cell's ``dist -fp`` lines are checked: one pair's shared
    count altered where it is produced makes the run not correct."""
    from fpmash_tpu_torch.commands import dist_cmd

    _add(tmp_path, "fp_cfl_workflow_reads")
    all_pairs = dist_cmd.all_pairs_dist

    def altered(*args, **kwargs):  # the first pair of every call
        for n, (ri, qi, res) in enumerate(all_pairs(*args, **kwargs)):
            res.numer += n == 0
            yield ri, qi, res

    monkeypatch.setattr(dist_cmd, "all_pairs_dist", altered)
    cell = spec.load_cell("fp_cfl_workflow_reads", tmp_path)
    r = runner.run_cell(cell, 2**31 + 3, 0.2, False, device="cpu")
    assert r["correct"] is False
    assert r["check"]["wrong_pairs"]["value"] >= 1
    assert r["check"]["wrong_hashes"]["value"] == 0
