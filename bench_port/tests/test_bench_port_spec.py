"""BENCHMARK.json keeps to its format's rules on names, units and shapes, and every
file it names is there; so do the cells of ``bench_port/later_cells.json``, added back."""

import json
import re

import pytest

from bench_port.tests.tiny import ROOT, with_later_cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPEC = with_later_cells(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def _names():
    out = [w[k] for w in SPEC["workloads"] for k in ("name", "config", "traffic")]
    out += [c["name"] for c in SPEC["configs"]] + [k for c in SPEC["configs"] for k in c["reduced"]]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        allowed.add("bound")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (ROOT / "bench_port" / "metrics" / f"{metric['name']}.py").is_file()
        allowed |= {"layer", "moves"}
    assert set(metric) <= allowed
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_unique_names_and_whys():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        for x in SPEC[group]:
            assert LINE.match(x["why"]), x["why"]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] in (1, 4)
    traffic = json.loads((ROOT / "bench_port" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    (cfg,) = [c for c in SPEC["configs"] if c["name"] == cell["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["name"] == cfg["name"]
    # the code each names is found by name, one file a name
    assert (ROOT / "bench_port" / "generators" / f"{traffic['generator']}.py").is_file()
    assert (ROOT / "bench_port" / "sketchers" / f"{config['reference']}.py").is_file()
    assert traffic["steps"] and any("check" in st for st in traffic["steps"])
    for st in traffic["steps"]:
        assert set(st) <= {"argv", "output", "check", "inputs"} and st["argv"]
        if "check" in st:
            assert (ROOT / "bench_port" / "checks" / f"{st['check']}.py").is_file()
    reports = lambda ms: [m for m in ms if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e = [m["name"] for m in reports(SPEC["end_to_end"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reports(SPEC["per_layer"])


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"] and BENCH["command"][1] == "bench_port/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_config_has_a_cell_and_later_cells_are_new():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert not cells & {w["name"] for w in SPEC["workloads"]
                        if w not in BENCH["workloads"]}
