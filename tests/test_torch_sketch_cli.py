"""Port: the fingerprint main path as a whole, through both CLIs.

``sketch --direct-fp`` / ``sketch -fp`` and ``dist -fp`` run through
``python -m fpmash_tpu_torch ... --device cpu`` (the plain versions of the
kernels) and through ``fpmash_tpu``'s CLI on the same inputs: the port must
reproduce the golden ``DNA3-sketch.msh`` hash for hash, write ``.msh``
bytes identical to the JAX package's, and print identical ``dist`` lines.
The factorization families other than CFL are held against the scalar
fingerprint ``.txt`` route as well as against the JAX package.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fpmash_tpu.models.sketch as jax_sketch_mod
import fpmash_tpu_torch.models.sketch as port_sketch_mod
from fpmash_tpu.cli import main as jax_main
from fpmash_tpu.models.fingerprint import extract_reads as jax_extract_reads
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models.fingerprint import extract_reads
from fpmash_tpu_torch.utils.msh import read_msh

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _port_cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    return subprocess.run(
        [sys.executable, "-m", "fpmash_tpu_torch", *args, "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300, check=True,
    )


def _assert_golden(path, golden_dir):
    mine = read_msh(str(path))
    gold = read_msh(str(golden_dir / "cfl" / "DNA3-sketch.msh"))
    assert len(mine.references) == len(gold.references) == 5
    for m, g in zip(mine.references, gold.references):
        assert (m.name, m.comment, m.length) == (g.name, g.comment, g.length)
        assert list(map(int, m.hashes32)) == list(map(int, g.hashes32))


def test_direct_fp_cli_reproduces_golden_and_jax_bytes(golden_dir, tmp_path):
    fasta = str(golden_dir / "cfl" / "DNA3.fasta")
    proc = _port_cli("sketch", "--direct-fp", fasta, "-o", "port", cwd=tmp_path)
    assert "Writing to port.msh..." in proc.stderr
    _assert_golden(tmp_path / "port.msh", golden_dir)
    assert jax_main(["sketch", "--direct-fp", fasta, "-o", str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port.msh").read_bytes() == (tmp_path / "jax.msh").read_bytes()


def test_fp_txt_cli_reproduces_golden_and_jax_bytes(golden_dir, tmp_path):
    txt = str(golden_dir / "cfl" / "DNA3-CFL.txt")
    assert port_main(["sketch", "-fp", txt, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    _assert_golden(tmp_path / "port.msh", golden_dir)
    assert jax_main(["sketch", "-fp", txt, "-o", str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port.msh").read_bytes() == (tmp_path / "jax.msh").read_bytes()
    # -I/-C rename the first reference, as in the JAX package
    opts = ["-I", "first", "-C", "note", "-S", "7", "-s", "300"]
    assert port_main(["sketch", "-fp", txt, "-o", str(tmp_path / "p2"), *opts, "--device", "cpu"]) == 0
    assert jax_main(["sketch", "-fp", txt, "-o", str(tmp_path / "j2"), *opts]) == 0
    assert (tmp_path / "p2.msh").read_bytes() == (tmp_path / "j2.msh").read_bytes()


def test_sketch_from_arrays_equals_port_sketch(golden_dir, tmp_path):
    """The JAX Sketch's numpy fields build the port's Sketch."""
    reads = jax_extract_reads(str(golden_dir / "cfl" / "DNA3.fasta"), rev_com=True)
    jsk = jax_sketch_mod.Sketch(jax_sketch_mod.SketchParams().for_fingerprint())
    jsk.init_from_reads_fingerprint(reads, "CFL")
    conv = port_sketch_mod.sketch_from_arrays(
        dataclasses.asdict(jsk.params),
        [dict(name=r.name, comment=r.comment, length=r.length, hashes=r.hashes)
         for r in jsk.references],
    )
    own = port_sketch_mod.Sketch(port_sketch_mod.SketchParams().for_fingerprint())
    own.init_from_reads_fingerprint(
        extract_reads(str(golden_dir / "cfl" / "DNA3.fasta"), rev_com=True), "CFL", devices=(CPU,)
    )
    assert conv.params == own.params
    assert len(conv) == len(own) == 5
    for a, b in zip(conv.references, own.references):
        assert (a.name, a.comment, a.length) == (b.name, b.comment, b.length)
        assert np.array_equal(a.hashes, b.hashes)
    assert conv.reference_index(own.references[2].name) == 2
    conv.write_msh(str(tmp_path / "conv.msh"))
    jsk.write_msh(str(tmp_path / "jax.msh"))
    assert (tmp_path / "conv.msh").read_bytes() == (tmp_path / "jax.msh").read_bytes()


def _dist_lines(main, args, capsys):
    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize(
    "opts", [[], ["-t"], ["-C", "-d", "0.5"], ["-v", "1e-30"]], ids=["plain", "table", "comment", "pvalue"]
)
def test_dist_fp_lines_match_jax(golden_dir, capsys, opts):
    g = golden_dir / "cfl"
    args = ["dist", "-fp", str(g / "DNA3-sketch.msh"),
            *(str(g / f"DNA{i}-sketch.msh") for i in (1, 2, 3)), *opts]
    port = _dist_lines(port_main, [*args, "--device", "cpu"], capsys)
    jax = _dist_lines(jax_main, args, capsys)
    assert port == jax
    if not opts:
        assert len(port.splitlines()) == 5 * 15


def test_dist_fp_txt_reference_matches_jax(golden_dir, capsys):
    """A .txt reference sends every input through the fingerprint parser."""
    g = golden_dir / "cfl"
    args = ["dist", "-fp", str(g / "DNA3-CFL.txt"), str(g / "DNA1-CFL.txt")]
    port = _dist_lines(port_main, [*args, "--device", "cpu"], capsys)
    assert port == _dist_lines(jax_main, args, capsys)
    assert len(port.splitlines()) == 25


def _write_fasta(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">r{i} G{i:04d}\n{s}\n")


@pytest.mark.parametrize("shift", ["shift", "no_shift"])
def test_direct_fp_read_quirks_match_jax(tmp_path, capsys, shift):
    """Short, empty, lower-case and non-ACGT reads, both shift modes, and
    enough references for the JAX package's device walk route (>= 64 pairs)."""
    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGTACGTACGTNacgt", np.uint8)
    def reads(n, shortest):
        lens = rng.integers(100, 170, size=n)
        lens[:3] = [shortest, 7, 99]
        return [lut[rng.integers(0, len(lut), size=int(m))].tobytes().decode() for m in lens]
    _write_fasta(tmp_path / "a.fa", reads(9, 0))  # an empty read: one empty window
    _write_fasta(tmp_path / "b.fa", reads(8, 1))
    for tag in ("a", "b"):
        base = ["sketch", "--direct-fp", str(tmp_path / f"{tag}.fa"), "--shift", shift]
        assert port_main([*base, "-o", str(tmp_path / f"p{tag}"), "--device", "cpu"]) == 0
        assert jax_main([*base, "-o", str(tmp_path / f"j{tag}")]) == 0
        assert (tmp_path / f"p{tag}.msh").read_bytes() == (tmp_path / f"j{tag}.msh").read_bytes()
    # (a reference of length 0 has no p-value in either package: dist b x b)
    args = ["dist", "-fp", str(tmp_path / "pb.msh"), str(tmp_path / "pb.msh")]
    port = _dist_lines(port_main, [*args, "--device", "cpu"], capsys)
    assert port == _dist_lines(jax_main, args, capsys)
    assert len(port.splitlines()) == 64


def test_line_cap_matches_jax(golden_dir, monkeypatch):
    """The global 1e6-line cap, shrunk so that it cuts DNA3 mid-read."""
    monkeypatch.setattr(jax_sketch_mod, "LIMIT_READ_FINGERPRINT", 2500)
    monkeypatch.setattr(port_sketch_mod, "LIMIT_READ_FINGERPRINT", 2500)
    reads = extract_reads(str(golden_dir / "cfl" / "DNA3.fasta"), rev_com=True)
    port = port_sketch_mod.Sketch(port_sketch_mod.SketchParams().for_fingerprint())
    port.init_from_reads_fingerprint(reads, devices=(CPU,))
    jax = jax_sketch_mod.Sketch(jax_sketch_mod.SketchParams().for_fingerprint())
    jax.init_from_reads_fingerprint(reads)
    txt = [str(golden_dir / "cfl" / "DNA3-CFL.txt")]
    port_txt = port_sketch_mod.Sketch(port_sketch_mod.SketchParams().for_fingerprint())
    port_txt.init_from_fingerprints(txt, device=CPU)
    jax_txt = jax_sketch_mod.Sketch(jax_sketch_mod.SketchParams().for_fingerprint())
    jax_txt.init_from_fingerprints(txt)
    for a, b in ((port, jax), (port_txt, jax_txt)):
        assert [len(r.hashes) for r in a.references] == [2000, 500]
        for x, y in zip(a.references, b.references, strict=True):
            assert (x.name, x.length) == (y.name, y.length)
            assert np.array_equal(x.hashes, y.hashes)


def test_unported_routes_say_so(golden_dir, tmp_path, capsys):
    """An unknown factorization is refused before any work.  ``-W``, which
    raised here until windowed sketches were ported, now gives the JAX
    package's ``.msw`` bytes and ``dist -W`` lines."""
    fasta = str(golden_dir / "cfl" / "DNA3.fasta")
    with pytest.raises(ValueError, match=r"unknown factorization 'LYNDON'.*'CFL_COMB'.*'ICFL'"):
        port_main(["sketch", "--direct-fp", fasta, "--factorization", "LYNDON",
                   "-o", str(tmp_path / "x"), "--device", "cpu"])
    assert not (tmp_path / "x.msh").exists()
    assert port_main(["sketch", "-W", fasta, "-o", str(tmp_path / "x"), "--device", "cpu"]) == 0
    assert jax_main(["sketch", "-W", fasta, "-o", str(tmp_path / "j")]) == 0
    assert not (tmp_path / "x.msh").exists()
    assert (tmp_path / "x.msw").read_bytes() == (tmp_path / "j.msw").read_bytes()
    port = _dist_lines(port_main, ["dist", "-W", fasta, fasta, "--device", "cpu"], capsys)
    assert port == _dist_lines(jax_main, ["dist", "-W", fasta, fasta], capsys)
    assert len(port.splitlines()) == 25


@pytest.mark.parametrize("family", ["ICFL", "ICFL_COMB", "CFL_COMB", "CFL_ICFL_COMB-10"])
def test_direct_fp_families_match_txt_route_and_jax(tmp_path, family):
    """``--direct-fp --factorization F`` against three things: the port's
    ``sketch -fp`` of the scalar fingerprint ``.txt``, the JAX package's
    ``init_from_reads_fingerprint`` (through ``sketch_from_arrays``), and the
    ``.msh`` bytes of both CLIs.  Reads: shift-window reads, one of exactly
    100, reads shorter than 100 (one window each), N-bearing bases."""
    from fpmash_tpu.models.fingerprint import fingerprint_reads as jax_fingerprint_reads

    rng = np.random.default_rng(17)
    lut = np.frombuffer(b"ACGTACGTACGTN", np.uint8)
    seqs = [lut[rng.integers(0, len(lut), size=m)].tobytes().decode()
            for m in (131, 100, 57, 1, 99, 12)]
    reads = [(f"R{k}", seq) for k, seq in enumerate(seqs)]
    params = port_sketch_mod.SketchParams().for_fingerprint()

    port = port_sketch_mod.Sketch(params)
    port.init_from_reads_fingerprint(reads, family, devices=(CPU,))
    fp_lines, _ = jax_fingerprint_reads(reads, family, backend="scalar")
    (tmp_path / "fp.txt").write_text("".join(fp_lines))
    via_txt = port_sketch_mod.Sketch(params)
    via_txt.init_from_fingerprints([str(tmp_path / "fp.txt")], device=CPU)
    jsk = jax_sketch_mod.Sketch(jax_sketch_mod.SketchParams().for_fingerprint())
    jsk.init_from_reads_fingerprint(reads, family)
    via_jax = port_sketch_mod.sketch_from_arrays(
        dataclasses.asdict(jsk.params),
        [dict(name=r.name, comment=r.comment, length=r.length, hashes=r.hashes)
         for r in jsk.references],
    )
    assert len(port) == len(via_txt) == len(via_jax) == len(reads)
    for other in (via_txt, via_jax):
        for a, b in zip(port.references, other.references, strict=True):
            assert (a.name, a.comment, a.length) == (b.name, b.comment, b.length)
            assert np.array_equal(a.hashes, b.hashes)

    _write_fasta(tmp_path / "r.fa", seqs)
    base = ["sketch", "--direct-fp", str(tmp_path / "r.fa"), "--factorization", family]
    assert port_main([*base, "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_main([*base, "-o", str(tmp_path / "j")]) == 0
    assert (tmp_path / "p.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
