"""Port: the host verbs ``contain``, ``paste``, ``info``, ``bounds``,
``taxscreen``, ``generate`` and ``mapping``, through both CLIs.

``python -m fpmash_tpu_torch ... --device cpu`` and ``fpmash_tpu``'s CLI run
on the same inputs (golden sketches from ``tests/golden/`` and seeded
genomes): the port must print the same lines and write the same bytes, and
``info -d`` must reproduce the reference's JSON dumps of the DNA goldens and
the reads golden.  ``chip_smoke.py`` holds the port's outputs on the card
against digests of the JAX package's; the last test keeps those digests
equal to that CLI's outputs.
"""

import hashlib
import shutil
import sys

import numpy as np
import pytest

import chip_smoke
from fpmash_tpu.cli import main as jax_main
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.utils.info_json import load_info_json

CPU = ["--device", "cpu"]


def _run(main, args, capsys):
    capsys.readouterr()
    rc = main(args)
    return rc, capsys.readouterr().out


def _both(args, capsys, port_extra=CPU):
    """``(rc, stdout)`` of the port (on the CPU) and of the JAX CLI; equal."""
    port = _run(port_main, [*args, *port_extra], capsys)
    jax = _run(jax_main, args, capsys)
    assert port == jax
    return port


def _dna(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].tobytes().decode()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two genomes with taxids in their comments, reads of the first, and
    their sketches (``refs.msh``, s = 200), written by the JAX CLI."""
    d = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(77)
    g1, g2 = _dna(rng, 3000), _dna(rng, 3000)
    (d / "g1.fasta").write_text(f">g1 taxid 11\n{g1}\n")
    (d / "g2.fasta").write_text(f">g2 taxid 12\n{g2}\n")
    starts = rng.integers(0, len(g1) - 150, size=80)
    (d / "reads.fastq").write_text(
        "".join(f"@r{i}\n{g1[s:s + 150]}\n+\n{'I' * 150}\n" for i, s in enumerate(starts)))
    (d / "multi.fasta").write_text(f">a x\n{g1[:500]}\n>b y\n{g2[100:900]}\n")
    assert jax_main(["sketch", str(d / "g1.fasta"), str(d / "g2.fasta"),
                     "-o", str(d / "refs"), "-s", "200"]) == 0
    assert port_main(["sketch", str(d / "g1.fasta"), str(d / "g2.fasta"),
                      "-o", str(d / "port_refs"), "-s", "200", *CPU]) == 0
    assert (d / "refs.msh").read_bytes() == (d / "port_refs.msh").read_bytes()
    return d


@pytest.mark.parametrize("case", ["loose", "default", "comment_fasta", "individual"])
def test_contain_equals_jax(world, capsys, case):
    refs = str(world / "refs.msh")
    args = {
        "loose": ["-e", "1.0", refs, refs],
        "default": [refs, refs],
        "comment_fasta": ["-e", "1.0", "-C", refs, str(world / "g1.fasta"),
                          str(world / "reads.fastq")],
        "individual": ["-e", "1.0", "-i", "-s", "200", str(world / "g1.fasta"),
                       str(world / "multi.fasta")],
    }[case]
    rc, out = _both(["contain", *args], capsys)
    assert rc == 0
    lines = [line.split("\t") for line in out.splitlines()]
    if case == "loose":
        assert len(lines) == 4
        g1 = str(world / "g1.fasta")
        assert {(r, q): s for s, _, r, q in lines}[(g1, g1)] == "1"
    if case == "individual":
        assert [q for *_, q in lines] == ["a", "b"]


def test_paste_fp_quirks_equal_jax(golden_dir, tmp_path, capsys):
    """-fp pastes a .txt operand's sibling .msh (error without one) and
    needs a .msh operand's sibling .txt; -o takes the output last; an
    existing output is refused; -l reads lists; -l with -fp is refused."""
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(golden_dir / "cfl" / "DNA3-CFL.txt", d / "fp.txt")
        shutil.copy(golden_dir / "cfl" / "DNA1-CFL.txt", d / "lone.txt")
        shutil.copy(golden_dir / "cfl" / "DNA2-sketch.msh", d / "nosib.msh")
        main, extra = (port_main, CPU) if side == "port" else (jax_main, [])
        assert main(["sketch", "-fp", str(d / "fp.txt"), "-o", str(d / "fp"), *extra]) == 0
        genomes = [str(golden_dir / "mash_ref" / f"genome{i}.fna.msh") for i in (1, 2, 3)]
        (d / "list.txt").write_text("\n".join(genomes) + "\n")
    for args in (["-fp", "{d}/lone.txt", "{d}/out"],  # no sibling .msh
                 ["-fp", "{d}/out", "{d}/nosib.msh"],  # no sibling .txt
                 ["-fp", "{d}/fp.txt", "{d}/out", "-o"],
                 ["-fp", "{d}/out2", "{d}/fp.msh", "{d}/fp.txt"],
                 ["{d}/out", "{d}/fp.msh"],  # exists
                 ["{d}/bad", "{d}/fp.txt"],  # not a sketch
                 ["-l", "{d}/lst", "{d}/list.txt"],
                 ["-l", "-fp", "{d}/lst2", "{d}/list.txt"]):
        rcs = []
        for side, main in (("port", port_main), ("jax", jax_main)):
            argv = [a.format(d=tmp_path / side) for a in args]
            rcs.append(main(["paste", *argv]))
        assert rcs[0] == rcs[1], args
    for name in ("out.msh", "out2.msh", "lst.msh"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert not (tmp_path / "port" / "lst2.msh").exists()


@pytest.mark.parametrize("golden", ["cfl/DNA1-sketch", "cfl/DNA2-sketch", "cfl/DNA3-sketch",
                                    "new_data/reads"])
def test_info_dump_equals_jax_and_golden_json(golden_dir, capsys, golden):
    msh = str(golden_dir / f"{golden}.msh")
    rc, out = _both(["info", "-d", msh], capsys, [])
    assert rc == 0
    n = chip_smoke._check_info_json(out, golden_dir / f"{golden}.json")
    assert n == (1000 if golden == "new_data/reads" else 5000)
    mine = load_info_json(out)
    assert ("counts" in mine["sketches"][0]) == (golden == "new_data/reads")


@pytest.mark.parametrize("flags", [["-H"], ["-t"], ["-c"], [], ["-H", "-t"]],
                         ids=["header", "tabular", "counts", "listing", "exclusive"])
def test_info_modes_equal_jax(golden_dir, capsys, monkeypatch, flags):
    from fpmash_tpu.commands import common as jax_common

    # the JAX package's print_columns binds sys.stdout when it is imported
    monkeypatch.setattr(jax_common.print_columns, "__defaults__", (2, 2, sys.stdout))
    for msh in (golden_dir / "new_data" / "reads.msh", golden_dir / "cfl" / "DNA1-sketch.msh",
                golden_dir / "mash_ref" / "genome2.fna.msh"):
        rc, out = _both(["info", *flags, str(msh)], capsys, [])
        assert rc == (1 if flags == ["-H", "-t"] or (flags == ["-c"] and "reads" not in msh.name)
                      else 0)
    assert _run(port_main, ["info", str(golden_dir / "cfl" / "DNA1.fasta")], capsys)[0] == 1


@pytest.mark.parametrize("opts", [[], ["-k", "16", "-p", "0.95"], ["-k", "32", "-p", "0.5"]])
def test_bounds_equals_jax(capsys, opts):
    rc, out = _both(["bounds", *opts], capsys, [])
    assert rc == 0
    assert "Mash distance" in out and "Screen distance" in out and "1000000" in out


_NODES = ("1\t|\t1\t|\tno rank\t|\n10\t|\t1\t|\tgenus\t|\n"
          "11\t|\t10\t|\tspecies\t|\n12\t|\t10\t|\tspecies\t|\n")
_NAMES = ("1\t|\troot\t|\t\t|\tscientific name\t|\n10\t|\tTestus\t|\t\t|\tscientific name\t|\n"
          "11\t|\tTestus unus\t|\t\t|\tscientific name\t|\n"
          "12\t|\tTestus duo\t|\t\t|\tscientific name\t|\n")


@pytest.mark.parametrize("mapping", [False, True], ids=["comment_taxids", "mapping_file"])
def test_taxscreen_equals_jax(world, tmp_path, capsys, mapping):
    tax = tmp_path / "tax"
    tax.mkdir()
    (tax / "nodes.dmp").write_text(_NODES)
    (tax / "names.dmp").write_text(_NAMES)
    args = ["taxscreen", str(world / "refs.msh"), str(world / "reads.fastq"), "-t", str(tax)]
    if mapping:  # the mapping file overrides the comments' taxids
        (tmp_path / "map.txt").write_text(f"12\t{world / 'g1.fasta'}\n11\t{world / 'g2.fasta'}\n")
        args += ["-m", str(tmp_path / "map.txt")]
    rc, out = _both(args, capsys)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("%\thashes")
    dominant = "Testus duo" if mapping else "Testus unus"
    assert int(next(line for line in lines if dominant in line).split("\t")[1]) > 0
    assert _both(["taxscreen", str(world / "refs.msh"), str(world / "reads.fastq"),
                  "-t", str(tmp_path)], capsys)[0] == 1  # no taxonomy there


@pytest.mark.parametrize("pool,rc", [(">a\nACGTACGT\n>b\n\n>c\nACGTACGTACGTACGTACGT\n", 1),
                                     (">a\nACGT\n>n\n" + "N" * 30 + "\n", 0)],
                         ids=["short_records", "record_without_kmers"])
def test_taxscreen_pool_records_shorter_than_k(world, tmp_path, capsys, pool, rc):
    """A pool with no record of ``k`` bases stops with the JAX CLI's error;
    one record of ``k`` bases or more is enough, even with no valid k-mer."""
    (tmp_path / "nodes.dmp").write_text(_NODES)
    (tmp_path / "names.dmp").write_text(_NAMES)
    (tmp_path / "pool.fa").write_text(pool)
    assert _both(["taxscreen", str(world / "refs.msh"), str(tmp_path / "pool.fa"),
                  "-t", str(tmp_path)], capsys)[0] == rc


def test_generate_and_mapping_equal_jax(golden_dir, tmp_path, capsys):
    for side, main in (("port", port_main), ("jax", jax_main)):
        d = tmp_path / side
        d.mkdir()
        for fmt, seed in (("fasta", 3), ("fa", 4), ("fastq", 5)):
            assert main(["generate", "--path", str(d / f"dna_{fmt}"), "--format", fmt,
                         "--size", "350", "--number_dna_generate", "3",
                         "--gc_content", "0.6", "--seed", str(seed)]) == 0
        shutil.copy(golden_dir / "cfl" / "DNA1-CFL.txt", d / "fp.txt")
        (d / "long.txt").write_text("r1 3 4 | 5 6\nr2 12 | 0 7 7\n\nr3\n")
        for name in ("fp.txt", "long.txt"):
            assert main(["mapping", "--path", str(d), "--fingerprint", name]) == 0
    for name in ("dna_fasta.fasta", "dna_fa.fa", "dna_fastq.fastq", "mapped_fp.txt.txt",
                 "mapped_long.txt.txt"):
        port = (tmp_path / "port" / name).read_bytes()
        assert port == (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port" / "dna_fasta.fasta").read_text().count(">T00000") == 3


def test_chip_smoke_host_verb_digests_equal_jax_outputs(tmp_path):
    """The digests ``chip_smoke.py`` holds the card's outputs against are
    those of the JAX CLI on the CPU, and the port on the CPU gives them."""
    jax = chip_smoke._host_verb_runs(jax_main, tmp_path / "jax", [])
    assert {k: hashlib.sha256(v).hexdigest() for k, v in jax.items()} == \
        chip_smoke.HOST_VERB_SHA256
    assert chip_smoke._host_verb_runs(port_main, tmp_path / "port", CPU) == jax
