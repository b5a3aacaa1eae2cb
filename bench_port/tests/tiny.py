"""Sizes small enough for the CPU, by cell, for the benchmark's own tests: the cells of
``BENCHMARK.json`` and those of ``bench_port/later_cells.json``."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: traffic parameters that replace the cell's own in CPU tests
TINY = {
    "refseq_sketch_assemblies": {"pool": 4, "length": 20000, "family_size": 2,
                                 "inputs_per_job": 2},
    "fp_cfl_sketch_reads": {"pool": 3, "reads": 4, "read_length": 300},
    "fp_icflcomb_sketch_reads": {"pool": 3, "reads": 4, "read_length": 300},
    "refseq_sketch_reads": {"genome_length": 20000, "reads": 2000},
}


def with_later_cells(bench: dict) -> dict:
    """A copy of ``bench`` (``BENCHMARK.json``'s object) with the cells of
    ``bench_port/later_cells.json`` added back, as a later PR would add them."""
    out = copy.deepcopy(bench)
    later = json.loads((ROOT / "bench_port" / "later_cells.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        out[key] += later[key]
    for m in out["per_layer"]:
        m["workloads"] = m["workloads"] + later["per_layer_workloads"].get(m["name"], [])
    return out
