"""Helpers of the benchmark's own tests (CPU, tiny sizes; ``gpu`` tests
decide inside the test whether a card is present)."""

import json

import pytest

from bench_port.tests.tiny import ROOT, TINY, with_later_cells


@pytest.fixture(scope="session")
def later_root(tmp_path_factory):
    """A root whose ``BENCHMARK.json`` also holds the cells of
    ``bench_port/later_cells.json``, as a later PR would add them back, beside
    a link to this ``bench_port/``."""
    root = tmp_path_factory.mktemp("later")
    bench = with_later_cells(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "bench_port").symlink_to(ROOT / "bench_port")
    return root


@pytest.fixture
def tiny_cell(later_root):
    from bench_port.harness import spec

    cells = {w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}

    def make(name, root=ROOT):
        cell = spec.load_cell(name, root if name in cells else later_root)
        cell.traffic["params"].update(TINY.get(name, {}))
        return cell

    return make
