"""Port: CLI-level multi-device parity (counterpart of ``tests/test_multidevice_cli.py``).

Each command runs through the port's CLI on one CPU shard and on 8, and
through the JAX CLI on its 8 virtual devices (``FPMASH_DEVICES=8``); the
``.msh`` bytes or the printed lines must be identical.  The port's CLI
takes its devices from ``device.resolve_devices``, which gives one device
for ``--device cpu``; the tests monkeypatch it to 8 CPU shards, the
counterpart of the 8 host devices that ``tests/conftest.py`` forces on JAX.
The classic routes' chunk sizes are shrunk so that small inputs take the
direct route or several pool launches, and so spread over the shards.  A
shard whose kernel raises makes the command raise.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu.cli import main as jax_main
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models import sketch as port_sketch
from fpmash_tpu_torch.models.sketch import sketch_from_arrays
from fpmash_tpu_torch.ops import fused_cuda, kmers_cuda
from fpmash_tpu_torch.utils import trace as trace_mod

CPU = torch.device("cpu")


def _dna(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].tobytes().decode()


def _fasta(path, seqs):
    with open(path, "w") as fh:
        for i, seq in enumerate(seqs):
            fh.write(f">R{i} G{i}\n{seq}\n")


def _msh(path, rng, n_refs, sort=True, fingerprint=False):
    lists = []
    for _ in range(n_refs):
        h = rng.integers(0, 2**64 if sort else 2**32, size=int(rng.integers(20, 64)),
                         dtype=np.uint64)
        lists.append(np.unique(h) if sort else h)
    params = dict(kmer_size=21, sketch_size=64)
    if fingerprint:
        params = dict(kmer_size=1, sketch_size=1000, noncanonical=True, alphabet="0123456789",
                      fingerprint=True)
    sketch_from_arrays(params, [dict(name=f"s{i}", comment=f"c{i}", length=5000, hashes=h)
                                for i, h in enumerate(lists)]).write_msh(str(path))
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(12)
    d = tmp_path_factory.mktemp("multidevice")
    _fasta(d / "in.fasta", [_dna(rng, 300) for _ in range(3)])
    _fasta(d / "ns.fasta", [_dna(rng, 300) for _ in range(40)])
    _fasta(d / "fp.fasta", [_dna(rng, 150) for _ in range(20)])
    _fasta(d / "g.fna", [_dna(rng, 20000) for _ in range(2)])
    genome = _dna(rng, 3000)
    with open(d / "r.fq", "w") as fh:
        for i in range(600):
            p = int(rng.integers(0, len(genome) - 100))
            fh.write(f"@q{i}\n{genome[p : p + 100]}\n+\n{'I' * 100}\n")
    _msh(d / "ref.msh", rng, 12)
    _msh(d / "qry.msh", rng, 9)
    _msh(d / "fp.msh", rng, 20, sort=False, fingerprint=True)
    return d


def _port(argv, monkeypatch, capsys, shards):
    """The port's CLI on ``shards`` CPU shards: ``(stdout, trace spans)``."""
    monkeypatch.setattr(placement, "resolve_devices", lambda name: (CPU,) * shards)
    capsys.readouterr()
    was = trace_mod.enabled()
    trace_mod.enable(True)
    try:
        assert port_main([*argv, "--device", "cpu"]) == 0
    finally:
        trace_mod.enable(was)
    out = capsys.readouterr()
    return out.out, [line for line in out.err.splitlines() if line.startswith("[fpmash] ")]


def _jax(argv, monkeypatch, capsys):
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    capsys.readouterr()
    assert jax_main(argv) == 0
    return capsys.readouterr().out


def _sketch_bytes(argv, tmp_path, monkeypatch, capsys):
    """``.msh`` bytes of ``sketch argv -o ...`` by the port on 1 and 8 shards
    and by the JAX CLI, and the 8-shard run's spans."""
    _port([*argv, "-o", str(tmp_path / "p1")], monkeypatch, capsys, 1)
    _, spans = _port([*argv, "-o", str(tmp_path / "p8")], monkeypatch, capsys, 8)
    _jax([*argv, "-o", str(tmp_path / "j8")], monkeypatch, capsys)
    return [(tmp_path / f"{n}.msh").read_bytes() for n in ("p1", "p8", "j8")], spans


def _span(spans, stage):
    return [s for s in spans if s.startswith(f"[fpmash] {stage}:")]


@pytest.mark.parametrize("fact", ["CFL", "ICFL_COMB"])
def test_sketch_direct_fp_multidevice(world, tmp_path, monkeypatch, capsys, fact):
    """sketch --direct-fp shards its 900 windows over 8 shards, each with
    its span of the stream; .msh identical to 1 shard and to the JAX CLI."""
    calls = []
    orig = fused_cuda.fingerprint_hashes_plain
    monkeypatch.setattr(fused_cuda, "fingerprint_hashes_plain",
                        lambda *a: calls.append(a[0].numel()) or orig(*a))
    (p1, p8, j8), spans = _sketch_bytes(
        ["sketch", "--direct-fp", "--factorization", fact, str(world / "in.fasta")],
        tmp_path, monkeypatch, capsys)
    assert p1 == p8 == j8
    assert "shards=8" in _span(spans, "factorize+hash")[0]
    if fact == "CFL":
        assert len(calls) == 1 + 8 and max(calls[1:]) < calls[0]  # spans, not the stream


def test_sketch_direct_fp_no_shift_multidevice(world, tmp_path, monkeypatch, capsys):
    (p1, p8, j8), _ = _sketch_bytes(
        ["sketch", "--direct-fp", "--shift", "no_shift", str(world / "ns.fasta")],
        tmp_path, monkeypatch, capsys)
    assert p1 == p8 == j8


@pytest.mark.parametrize("route,opts", [("direct", []), ("direct", ["-M"]), ("pool", []),
                                        ("pool", ["-k", "15"])])
def test_classic_sketch_multidevice(world, tmp_path, monkeypatch, capsys, route, opts):
    """Classic sketching: the direct route's ten chunks, or the pool route's
    launches, round-robin over 8 shards."""
    if route == "direct":
        monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 4096)
    else:
        monkeypatch.setattr(port_sketch, "_POOL_CHUNK", 1024)
    (p1, p8, j8), spans = _sketch_bytes(["sketch", str(world / "g.fna"), *opts], tmp_path,
                                        monkeypatch, capsys)
    assert p1 == p8 == j8
    if route == "direct":
        assert "chunks=10" in _span(spans, "classic-direct")[0]
        assert "shards=8" in _span(spans, "classic-direct")[0]


@pytest.mark.parametrize("opts,route", [(["-r", "-m", "2"], "direct"), (["-r"], "direct"),
                                        (["-r", "-b", "20K"], "pool")],
                         ids=["min-cov", "reads", "bloom"])
def test_reads_sketch_multidevice(world, tmp_path, monkeypatch, capsys, opts, route):
    """Reads mode: ``-m 2`` through the collect-all route, ``-r`` through the
    direct route, ``-b`` through the pool route, whose hashes must come back
    in stream order for the Bloom admission."""
    monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 8192)
    monkeypatch.setattr(port_sketch, "_POOL_CHUNK", 4096)
    (p1, p8, j8), spans = _sketch_bytes(["sketch", *opts, str(world / "r.fq")], tmp_path,
                                        monkeypatch, capsys)
    assert p1 == p8 == j8
    stage = {"direct": "classic-direct" + ("-reads" if "-m" in opts else ""),
             "pool": "kmer-hash"}[route]
    assert _span(spans, stage)


@pytest.mark.parametrize("argv", [["dist", "ref.msh", "qry.msh"], ["dist", "-fp", "fp.msh", "fp.msh"],
                                  ["triangle", "ref.msh"], ["triangle", "-fp", "fp.msh"]],
                         ids=["dist", "dist-fp", "triangle", "triangle-fp"])
def test_comparisons_multidevice(world, monkeypatch, capsys, argv):
    """dist and triangle (K9), dist -fp (K2) and triangle -fp (positional):
    the query axis (rows for -fp triangles) over 8 shards."""
    argv = [a if not a.endswith(".msh") else str(world / a) for a in argv]
    out1, _ = _port(argv, monkeypatch, capsys, 1)
    out8, spans = _port(argv, monkeypatch, capsys, 8)
    assert out1 == out8 == _jax(argv, monkeypatch, capsys)
    assert out1.count("\n") > 10
    if argv[0] == "dist" or "-fp" not in argv:
        stage = "all-pairs-walk" if "-fp" in argv else "all-pairs-compare"
        assert "shards=8" in _span(spans, stage)[0]


def test_dist_fp_of_direct_fp_sketches_multidevice(world, tmp_path, monkeypatch, capsys):
    """The fingerprint workflow end to end on 8 shards: sketch --direct-fp,
    then dist -fp of the sketch against itself."""
    fp = str(world / "fp.fasta")
    _port(["sketch", "--direct-fp", fp, "-o", str(tmp_path / "p")], monkeypatch, capsys, 8)
    _jax(["sketch", "--direct-fp", fp, "-o", str(tmp_path / "j")], monkeypatch, capsys)
    assert (tmp_path / "p.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    argv = ["dist", "-fp", str(tmp_path / "p.msh"), str(tmp_path / "p.msh")]
    out8, _ = _port(argv, monkeypatch, capsys, 8)
    assert out8 == _jax(argv, monkeypatch, capsys)
    assert out8.count("\n") == 400


def _raise_on_third(monkeypatch, module, name):
    orig = getattr(module, name)
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a shard's kernel failed")
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, failing)


@pytest.mark.parametrize("what", ["direct-fp", "classic"])
def test_a_failing_shard_makes_the_command_raise(world, tmp_path, monkeypatch, capsys, what):
    """No fallback hides a shard's failure: the command raises, and no
    sketch is written."""
    if what == "direct-fp":
        _raise_on_third(monkeypatch, fused_cuda, "fingerprint_hashes_plain")
        argv = ["sketch", "--direct-fp", str(world / "in.fasta")]
    else:
        monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 4096)
        _raise_on_third(monkeypatch, kmers_cuda, "kmer_hashes_masked_planes")
        argv = ["sketch", "-s", "1000", str(world / "g.fna")]
    with pytest.raises(RuntimeError, match="a shard's kernel failed"):
        _port([*argv, "-o", str(tmp_path / "x")], monkeypatch, capsys, 8)
    assert not (tmp_path / "x.msh").exists()
