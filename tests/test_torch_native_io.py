"""Port: the native FASTA/FASTQ reader and fingerprint-file parser
(``fpmash_tpu_torch/native/fpio.cpp`` through ``utils/native.py``).

The JAX CLI reads every plain file with its native reader, which differs
from its pure-Python one on CRLF line ends, blanks inside sequence lines
and some malformed FASTQ; ``.gz`` files and ``-`` take the Python one.  The
port must read as that CLI does: its outputs on such files (``sketch``,
``sketch -i``, ``sketch -r``, ``fingerprint``) equal the JAX CLI's byte for
byte, its parser's arrays equal the JAX parser's, and a failed build of the
library raises instead of falling back.
"""

import gzip
import io
import shutil
import sys

import numpy as np
import pytest

import chip_smoke
import fpmash_tpu.utils.native as jax_native
from fpmash_tpu.cli import main as jax_main
from fpmash_tpu.utils.fasta import read_sequences as jax_read_sequences
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.ops import _build
from fpmash_tpu_torch.utils import native, native_lyndon
from fpmash_tpu_torch.utils import trace as trace_mod
from fpmash_tpu_torch.utils.fasta import read_sequences, reader

GOLDENS = ["cfl/DNA3.fasta", "new_data/reads1.fastq", "lyn2vec_basic/example_transcripts_genes.fa"]


#: the edge files the CLIs sketch and fingerprint (F2)
F2_FILES = list(chip_smoke.EDGE_CLI_FILES)


@pytest.fixture(scope="module", autouse=True)
def jax_native_reader():
    # the JAX CLI reads plain files with it; without it there is nothing to compare
    assert jax_native.available(), "the JAX package's native library does not build"


@pytest.fixture(scope="module")
def edge_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("edge")
    for name, data in chip_smoke.edge_files().items():
        (d / name).write_bytes(data)
    return d


def _records(reads):
    return [tuple(r) for r in reads]


# ---------------------------------------------------------------------- #
# F2: both CLIs on the edge files
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("name", F2_FILES)
@pytest.mark.parametrize("flags", [[], ["-i"], ["-r"]], ids=["sketch", "sketch-i", "sketch-r"])
def test_sketch_of_edge_file_equals_jax_cli(edge_dir, tmp_path, name, flags):
    path = str(edge_dir / name)
    assert port_main(["sketch", *flags, path, "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_main(["sketch", *flags, path, "-o", str(tmp_path / "j")]) == 0
    assert (tmp_path / "p.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


@pytest.mark.parametrize("name", F2_FILES)
def test_fingerprint_of_edge_file_equals_jax_cli(edge_dir, tmp_path, name):
    for tag, main, extra in (("p", port_main, ["--device", "cpu"]),
                             ("j", jax_main, ["--backend", "scalar"])):
        (tmp_path / tag).mkdir()
        shutil.copy(edge_dir / name, tmp_path / tag / name)
        assert main(["fingerprint", "--path", str(tmp_path / tag), "--fasta", name, *extra]) == 0
    for out in ("fingerprint_CFL.txt", "fact_fingerprint_CFL.txt"):
        assert (tmp_path / "p" / out).read_bytes() == (tmp_path / "j" / out).read_bytes()


def test_edge_file_digests_are_the_jax_clis(tmp_path):
    """``chip_smoke.EDGE_SHA256`` holds the JAX CLI's outputs on the edge
    files, which the port's CLI on the card must reproduce (on the CPU, the
    tests above hold the two CLIs' outputs equal)."""
    import hashlib

    jax = chip_smoke.edge_file_runs(jax_main, tmp_path / "j", [], ["--backend", "scalar"])
    assert {k: hashlib.sha256(v).hexdigest() for k, v in jax.items()} == chip_smoke.EDGE_SHA256


def test_native_reader_keeps_carriage_returns_and_blanks(edge_dir):
    """The native reader keeps a CRLF header's ``\\r`` (kseq does), in the
    comment, or in the name when there is no comment; and the blanks of a
    sequence line but its ``\r``."""
    first = next(read_sequences(str(edge_dir / "crlf_comments.fa")))
    assert (first.name, first.comment) == ("r0", "sample 0\r")
    assert next(read_sequences(str(edge_dir / "crlf_plain.fa"))).name == "r0\r"
    seq = next(read_sequences(str(edge_dir / "blanks.fa"))).seq
    assert len(seq) == 305 and "  \t" in seq and seq.endswith(" \t")  # blanks kept


# ---------------------------------------------------------------------- #
# the parser against the JAX package's
# ---------------------------------------------------------------------- #


def _path(golden_dir, edge_dir, case: str) -> str:
    return str(golden_dir / case) if case in GOLDENS else str(edge_dir / case)


@pytest.mark.parametrize("case", GOLDENS + list(chip_smoke.edge_files()))
def test_parse_seq_file_equals_jax(golden_dir, edge_dir, case):
    path = _path(golden_dir, edge_dir, case)
    names, comments, blob, offsets = native.parse_seq_file(path)
    want = jax_native.parse_seq_file(path)
    assert (names, comments, blob) == want[:3]
    assert offsets.dtype == want[3].dtype and np.array_equal(offsets, want[3])
    assert _records(read_sequences(path)) == _records(jax_read_sequences(path))


def test_non_ascii_byte_decodes_as_in_the_jax_cli(edge_dir):
    recs = list(read_sequences(str(edge_dir / "non_ascii.fa")))
    assert recs[0].comment == "café"
    assert recs[0].seq.count("�") == 2  # the two bytes of U+00E9, each replaced


@pytest.mark.parametrize("case", ["crlf_comments.fa", "blanks.fa", "blank_lines.fq",
                                  "multiline.fq", "cfl/DNA3.fasta"])
def test_gz_and_stdin_take_the_python_reader_as_in_jax(golden_dir, edge_dir, tmp_path,
                                                       monkeypatch, case):
    """``.gz`` and ``-`` read as the JAX package reads them (its Python
    reader), so they differ from the plain file exactly where the JAX
    package's do."""
    path = _path(golden_dir, edge_dir, case)
    gz = tmp_path / "x.gz"
    with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    assert reader(str(gz)) == reader("-") == "python" and reader(path) == "native"
    assert _records(read_sequences(str(gz))) == _records(jax_read_sequences(str(gz)))
    text = open(path).read()
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    port_stdin = _records(read_sequences("-"))
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert port_stdin == _records(jax_read_sequences("-"))
    assert port_stdin == _records(read_sequences(path, native=False))
    port_differs = _records(read_sequences(path)) != port_stdin
    jax_differs = _records(jax_read_sequences(path)) != _records(jax_read_sequences(str(gz)))
    assert port_differs == jax_differs == (case != "cfl/DNA3.fasta")


def test_read_sequences_span_names_the_reader(edge_dir, tmp_path, monkeypatch, capsys):
    gz = tmp_path / "r.fa.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write((edge_dir / "blanks.fa").read_bytes())
    monkeypatch.setattr(trace_mod, "_ENABLED", True)
    for path, tag in ((str(edge_dir / "blanks.fa"), "native"), (str(gz), "python")):
        capsys.readouterr()
        assert port_main(["sketch", path, "-o", str(tmp_path / "s"), "--device", "cpu"]) == 0
        spans = [line for line in capsys.readouterr().err.splitlines() if "read-sequences" in line]
        assert spans and all(f"reader={tag}" in line for line in spans)
    capsys.readouterr()
    assert port_main(["sketch", "-r", str(edge_dir / "crlf.fq"), str(gz), "-o",
                      str(tmp_path / "r"), "--device", "cpu"]) == 0
    assert "reader=native|python" in capsys.readouterr().err


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_seq_file(str(tmp_path / "absent.fa"))
    with pytest.raises(FileNotFoundError):
        list(read_sequences(str(tmp_path / "absent.fa")))
    with pytest.raises(IsADirectoryError):
        native.parse_seq_file(str(tmp_path))


# ---------------------------------------------------------------------- #
# the fingerprint-file parser (copies of tests/test_native_io.py's cases)
# ---------------------------------------------------------------------- #


def test_fingerprint_parser_matches_python(golden_dir):
    path = str(golden_dir / "cfl" / "DNA3-CFL.txt")
    ids, values, offsets = native.parse_fingerprint_file(path)
    lines = open(path).read().splitlines()
    assert len(ids) == len(lines)
    for i, line in enumerate(lines):
        parts = line.split()
        assert ids[i] == parts[0]
        assert [int(v) for v in values[offsets[i] : offsets[i + 1]]] == [int(x) for x in parts[1:]]
    want = jax_native.parse_fingerprint_file(path)
    assert ids == want[0] and np.array_equal(values, want[1]) and np.array_equal(offsets, want[2])


def test_fingerprint_parser_line_cap(tmp_path):
    f = tmp_path / "fp.txt"
    f.write_text("a 1\nb 2\nc 3\n")
    ids, values, offsets = native.parse_fingerprint_file(str(f), max_lines=2)
    assert ids == ["a", "b"]


def test_fingerprint_parser_stops_at_non_integer(tmp_path):
    # mirrors `ss >> uint64_t` halting on a non-numeric token
    f = tmp_path / "fp.txt"
    f.write_text("x 1 2 oops 3\n")
    ids, values, offsets = native.parse_fingerprint_file(str(f))
    assert [int(v) for v in values] == [1, 2]


# ---------------------------------------------------------------------- #
# the host build
# ---------------------------------------------------------------------- #


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory, and no library loaded yet in this process."""
    caches = (_build.host_library, native._lib, native_lyndon._lib)
    for cache in caches:
        cache.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    yield tmp_path / "build"
    for cache in caches:
        cache.cache_clear()


def test_host_library_builds_into_build_dir_at_first_use(fresh_build, golden_dir):
    assert not fresh_build.exists()
    path = str(golden_dir / "cfl" / "DNA3.fasta")
    assert _records(read_sequences(path)) == _records(jax_read_sequences(path))
    assert native_lyndon.factorize_batch_native(["ACGT"], "CFL") == [[4]]
    built = sorted(p.name for p in fresh_build.iterdir())
    assert built == sorted([_build.host_library_path("fpio").name,
                            _build.host_library_path("lyndon").name])
    assert all(name.endswith(".so") for name in built)


@pytest.mark.parametrize("cxx,message", [
    ("/nonexistent/bin/g++", "No such file"),
    ("sh -c 'echo broken compiler >&2; exit 3' cc", "broken compiler"),
], ids=["missing", "failing"])
def test_failed_host_build_raises(fresh_build, golden_dir, monkeypatch, cxx, message):
    monkeypatch.setenv("CXX", cxx)
    path = str(golden_dir / "cfl" / "DNA3.fasta")
    with pytest.raises(RuntimeError, match=message):
        native.parse_seq_file(path)
    with pytest.raises(RuntimeError, match=message):
        list(read_sequences(path))  # no fall back to the Python reader
    with pytest.raises(RuntimeError, match=message):
        native_lyndon.factorize_batch_native(["ACGT"], "CFL")
    assert not native.available() and not native_lyndon.available()
    assert not fresh_build.exists() or not list(fresh_build.glob("*.so"))
    assert list(read_sequences(path, native=False))  # asked for, the Python reader still reads
