"""Port rules: no JAX in the port, explicit devices, layers that import one way,
and the kernels on the card.

The tests marked ``gpu`` build the CUDA kernels and hold each one against
its plain PyTorch version; without a usable card they skip with a reason.
On a machine with one (JAX need not be installed there), run them with
``python -m pytest tests/test_torch_port_rules.py -m gpu --noconftest``
(the new kernels' own ``gpu`` tests are in tests/test_torch_kmer_variants.py,
tests/test_torch_row_sort.py and tests/test_torch_fingerprint.py, the
windowed sketches' in tests/test_torch_winnow.py, the sharded routes' in
tests/test_torch_parallel.py).
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.device import resolve_devices
from fpmash_tpu_torch.ops import fused_cuda, walk_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]

_LIST_MODULES = """
import importlib, pkgutil, sys
before = set(sys.modules)
import fpmash_tpu_torch
{imports}
new = sorted(m for m in set(sys.modules) - before
             if m.split('.')[0] in ('jax', 'jaxlib', 'fpmash_tpu'))
print(repr(new))
"""


def _new_jax_modules(imports: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", _LIST_MODULES.format(imports=imports)],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    return ast.literal_eval(out.stdout.strip().splitlines()[-1])


def test_cli_import_loads_no_jax():
    assert _new_jax_modules("import fpmash_tpu_torch.cli") == []


def test_no_module_of_the_port_loads_jax():
    walk = (
        "for m in pkgutil.walk_packages(fpmash_tpu_torch.__path__, 'fpmash_tpu_torch.'):\n"
        "    if m.name != 'fpmash_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)"
    )
    assert _new_jax_modules(walk) == []


@pytest.mark.parametrize("module", [
    "fpmash_tpu_torch.ops.compare", "fpmash_tpu_torch.ops.compare_cuda",
    "fpmash_tpu_torch.commands.triangle_cmd", "fpmash_tpu_torch.commands.screen_cmd",
    "fpmash_tpu_torch.utils.codon",
])
def test_slice4_module_loads_no_jax(module):
    assert _new_jax_modules(f"import {module}") == []


_SHARDED_ROUTES = """
import numpy as np, torch
from fpmash_tpu_torch.models.sketch import Sketch, SketchParams
from fpmash_tpu_torch.models.distance import common_denom
from fpmash_tpu_torch.utils.kfinger import compute_windows
mesh = (torch.device("cpu"),) * 4
sk = Sketch(SketchParams().for_fingerprint())
sk.init_from_reads_fingerprint([("a", "ACGTTGCA" * 30), ("b", "TTGACA" * 40)], "ICFL_COMB",
                               devices=mesh)
lists = [r.hashes for r in sk.references]
common_denom(lists, lists, 1000, devices=mesh)
common_denom([np.sort(h) for h in lists], [np.sort(h) for h in lists], 1000, devices=mesh)
assert compute_windows([3, 1, 2], 2) == [[1, 3], [1, 2]]
"""


@pytest.mark.parametrize("module", [
    "fpmash_tpu_torch.device", "fpmash_tpu_torch.parallel.sharded",
    "fpmash_tpu_torch.utils.kfinger", "fpmash_tpu_torch.commands.common",
])
def test_slice12_module_loads_no_jax(module):
    assert _new_jax_modules(f"import {module}") == []


def test_sharded_routes_load_no_jax():
    """The sharded routes (``parallel/sharded.py`` through ``--direct-fp``,
    the walk K2 and the sorted comparison K9, on 4 CPU shards) and the
    k-finger helpers run without loading a JAX module."""
    assert _new_jax_modules(_SHARDED_ROUTES) == []


_NO_BUILD = """
import subprocess
def _refuse(*args, **kwargs):
    raise AssertionError(f"a process was started while importing: {args}")
subprocess.Popen = subprocess.run = _refuse
import fpmash_tpu_torch.ops.sort_cuda, fpmash_tpu_torch.ops.kmers_cuda
import fpmash_tpu_torch.ops.fused_cuda, fpmash_tpu_torch.ops.winnow
from fpmash_tpu_torch.ops import _build
assert _build.library.cache_info().currsize == 0, "the kernels' library was loaded"
"""


def test_slice5_wrappers_load_no_jax_and_build_nothing():
    """``ops/sort_cuda.py`` (K15), the wrappers extended with K10-K13 and
    ``ops/winnow.py`` (the minmer kernel)."""
    assert _new_jax_modules(_NO_BUILD) == []


_SMOKE_STEPS = """
import numpy as np, torch
import chip_smoke
flat = torch.from_numpy(np.frombuffer(b"ACGTTGCAACGTAC" * 40, np.uint8).copy())
starts = torch.arange(0, 400, 7, dtype=torch.int64)
lengths = torch.full_like(starts, 100, dtype=torch.int32)
for family in ("ICFL_COMB", "CFL_COMB"):
    assert chip_smoke._factor_steps((flat, starts, lengths), family, [0, 1, 2]) > 1
"""


def test_chip_smoke_step_count_loads_no_jax():
    """``chip_smoke.py`` counts K3's and K14's automaton steps with the numpy
    model of tests/test_torch_factor_body.py; doing so loads no JAX."""
    assert _new_jax_modules(_SMOKE_STEPS) == []


_SMOKE_FP_STEPS = """
import numpy as np, torch
import chip_smoke
flat = torch.from_numpy(np.frombuffer(b"ACGTTGCAACGTAC" * 40, np.uint8).copy())
starts = torch.arange(0, 400, 7, dtype=torch.int64)
lengths = torch.full_like(starts, 100, dtype=torch.int32)
assert chip_smoke._fingerprint_steps((flat, starts, lengths), [0, 1, 2]) > 1
"""


def test_chip_smoke_fingerprint_step_count_loads_no_jax():
    """``chip_smoke.py`` counts K1's Duval steps with the numpy model of
    tests/test_torch_fingerprint_body.py; doing so loads no JAX."""
    assert _new_jax_modules(_SMOKE_FP_STEPS) == []


@pytest.mark.parametrize("verb", ["triangle", "screen", "find", "contain", "taxscreen",
                                  "sketch -W"])
def test_comparison_verbs_default_to_cuda(monkeypatch, golden_dir, tmp_path, verb):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    msh = str(golden_dir / "mash_ref" / "genome1.fna.msh")
    fastq = str(golden_dir / "new_data" / "reads1.fastq")
    fasta = str(golden_dir / "cfl" / "DNA1.fasta")
    argv = {"triangle": ["triangle", msh], "screen": ["screen", msh, fastq],
            "find": ["find", fasta, fastq], "contain": ["contain", msh, fastq],
            "taxscreen": ["taxscreen", msh, fastq, "-t", str(tmp_path)],
            "sketch -W": ["sketch", "-W", fasta, "-o", str(tmp_path / "w")]}[verb]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(argv)
    assert not (tmp_path / "w.msw").exists()


def _verbs(parser) -> list[str]:
    import argparse

    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return list(action.choices)


def test_port_cli_registers_every_verb_of_the_jax_cli():
    from fpmash_tpu.cli import build_parser as jax_parser
    from fpmash_tpu_torch.cli import build_parser

    jax_verbs = _verbs(jax_parser())
    assert len(jax_verbs) == 13  # ten Mash verbs and three lyn2vec ones
    assert _verbs(build_parser()) == jax_verbs


def test_cuda_device_without_a_card_raises(monkeypatch, golden_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_devices("cuda")
    txt = str(golden_dir / "cfl" / "DNA3-CFL.txt")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(["sketch", "-fp", txt, "-o", str(tmp_path / "x")])  # default is cuda
    assert not (tmp_path / "x.msh").exists()
    assert resolve_devices("cpu") == (torch.device("cpu"),)
    with pytest.raises(RuntimeError, match="unsupported"):
        resolve_devices("meta")


PORT = REPO / "fpmash_tpu_torch"


def _port_imports(path: pathlib.Path):
    """``(module, names)`` of every import of the port in ``path``, at any
    depth: ``from fpmash_tpu_torch import device`` is the module
    ``fpmash_tpu_torch.device``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((a.name, []) for a in node.names if a.name.startswith("fpmash_tpu_torch."))
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "fpmash_tpu_torch"):
            if node.module == "fpmash_tpu_torch":
                yield from ((f"fpmash_tpu_torch.{a.name}", []) for a in node.names)
            else:
                yield node.module, [a.name for a in node.names]


def test_layers_import_one_way():
    """The module graph reads ``commands -> models -> parallel -> ops``, with
    ``device.py``, ``utils/trace.py`` and ``scalar/`` below them all: no
    import points up, even one made inside a function.  Commands import no
    private name of the layers below; the counted copies live in
    ``device.py`` alone; ``screen`` and ``taxscreen`` count their queries'
    k-mers through one route."""
    below = {
        "ops": {"ops", "device", "scalar", "utils.trace"},
        "parallel": {"ops", "parallel", "device", "utils.trace"},
        "models": {"models", "parallel", "ops", "device", "scalar", "utils"},
        "device": {"utils.trace"},
        "scalar": {"scalar"},
    }
    copies, wrong, reads = [], [], []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        layer = rel.parts[0] if len(rel.parts) > 1 else rel.stem
        tree = ast.parse(path.read_text())
        copies += [(str(rel), f.name) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                   and f.name in ("to_device", "to_host")]
        reads += [str(rel) for node in ast.walk(tree) if isinstance(node, (ast.Call, ast.Subscript))
                  and any(isinstance(c, ast.Constant) and c.value == "FPMASH_DEVICES"
                          for c in ast.iter_child_nodes(node))]
        for module, names in _port_imports(path):
            target = module.split(".")[1]  # ops, parallel, ..., or device, cli
            allowed = below.get(layer)
            if allowed is not None and not ({target, ".".join(module.split(".")[1:3])}
                                            & allowed):
                wrong.append(f"{rel} imports {module}")
            if layer == "commands" and target in ("models", "ops"):
                wrong += [f"{rel} imports {module}.{n}" for n in names if n.startswith("_")]
    assert wrong == []
    assert sorted(copies) == [("device.py", "to_device"), ("device.py", "to_host")]
    for command in ("screen_cmd.py", "taxscreen_cmd.py"):
        imported = dict(_port_imports(PORT / "commands" / command))
        assert "distinct_kmer_counts" in imported["fpmash_tpu_torch.models.sketch"], command
    assert reads == ["device.py"]  # FPMASH_DEVICES, read where --device becomes devices


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fingerprint_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(21)
    flat = np.frombuffer(b"ACGTNacgt", np.uint8)[rng.integers(0, 9, size=5000)]
    starts = rng.integers(0, 4900, size=3000).astype(np.int64)
    lengths = rng.integers(0, 101, size=3000).astype(np.int32)
    starts[:4], lengths[:4] = [0, 4999, -1, 4990], [0, 2, 1, 10]  # edges, 2 outside
    args = [torch.from_numpy(a).to(cuda_device) for a in (flat, starts, lengths)]
    before = fused_cuda.LAUNCHES
    got = fused_cuda.fingerprint_hashes(*args, 42)
    assert fused_cuda.LAUNCHES == before + 1
    want = fused_cuda.fingerprint_hashes_plain(*args, 42)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][:3].tolist() == [0, -1, -1]


@pytest.mark.gpu
def test_walk_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(22)
    ref = rng.integers(0, 40, size=(33, 70)).astype(np.uint64)
    qry = rng.integers(0, 40, size=(19, 50)).astype(np.uint64)
    ref[:5] |= np.uint64(1 << 63)
    rl = rng.integers(0, 71, size=33).astype(np.int32)
    ql = rng.integers(0, 51, size=19).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (ref.view(np.int64), rl, qry.view(np.int64), ql)]
    for cap in (10, 60, 1000):
        before = walk_cuda.LAUNCHES
        got = walk_cuda.pairwise_walk(*args, cap)
        assert walk_cuda.LAUNCHES == before + 1
        want = walk_cuda.pairwise_walk_plain(*args, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
