"""``BENCHMARK.json`` and the files it names, found by name under ``bench_port/``.

A cell's configuration is its ``file``; its traffic is
``bench_port/traffic/<traffic>.json``.  Code is found by name too, one module
a name, each under a folder of its kind:

* ``generators/<kind>.py``: ``make(rng, out, params) -> Pool``, the inputs a
  traffic file's ``generator`` names;
* ``sketchers/<reference>.py``: ``entries(items, cfg, expect, device,
  control) -> [[Want]]``, the plain reference's sketch of inputs, for the
  configuration's ``reference``;
* ``checks/<check>.py``: what a traffic step's ``check`` compares its output
  with (``LIMITS``, ``parse``, ``expected``, ``compare``, ``render``);
* ``metrics/<metric>.py``: ``read(run)``, a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``: its configuration's file,
    its traffic file ``bench_port/traffic/<traffic>.json``, and the metrics it
    reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    (cfg,) = [c for c in spec["configs"] if c["name"] == w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)], root=root)


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``bench_port/<kind>/<name>.py``."""
    path = root / "bench_port" / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench_port/metrics/<metric>.py``."""
    return module("metrics", metric, root).read
