"""Nothing under bench_port/ imports JAX or the JAX package, compared by whole
top-level module name (``fpmash_tpu_torch`` is not ``fpmash_tpu``), and the
plain reference imports nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from bench_port.tests.tiny import ROOT

BENCH = ROOT / "bench_port"
FORBIDDEN = {"jax", "jaxlib", "flax", "fpmash_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for d in ("reference", "sketchers", "checks",
                                                     "generators")
                                         for p in (BENCH / d).glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"fpmash_tpu_torch"})


def test_top_level_names_are_compared_whole():
    code = ("import sys; sys.path.insert(0, %r); from bench_port.harness import runner; "
            "import fpmash_tpu_torch.cli; print(runner.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port.harness import spec, runner\n"
            "from bench_port.tests.tiny import TINY\n"
            "cell = spec.load_cell('fp_cfl_sketch_reads')\n"
            "cell.traffic['params'].update(TINY['fp_cfl_sketch_reads'])\n"
            "r = runner.run_cell(cell, 11, 0.2, False, device='cpu')\n"
            "assert r['correct'], r\n"
            "print(runner.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
