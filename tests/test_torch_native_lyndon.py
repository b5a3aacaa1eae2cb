"""Port: the host factorizer (``fpmash_tpu_torch/native/lyndon.cpp`` through
``utils/native_lyndon.py``).

It factorizes the rows that the port keeps off the card (rows wider than
the card's ICFL bound, rows whose ``ok`` comes back false), so it must give
the scalar model's factor lengths (``scalar/lyndon.py``, markers stripped)
and the JAX package's native factorizer's, under every family, alphabet and
width; and the generalized ``fingerprint`` verb, whose wide chunks go to it,
must print the JAX CLI's bytes.
"""

import numpy as np
import pytest

import fpmash_tpu.utils.native_lyndon as jax_native_lyndon
from fpmash_tpu.cli import main as jax_main
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models import fingerprint
from fpmash_tpu_torch.models.fingerprint import scalar_lengths, scalar_rows
from fpmash_tpu_torch.ops.icfl_cuda import MAX_ICFL_WIDTH
from fpmash_tpu_torch.utils import native_lyndon
from fpmash_tpu_torch.utils import trace as trace_mod

FAMILIES = list(native_lyndon.ALG_IDS)
ALPHABETS = {"ACGT": b"ACGT", "ACGTN": b"ACGTN", "mixed_case": b"ACGTacgtNn",
             "other_bytes": b"ACGT!-.09XZ~"}
WIDTHS = (1, 2, 99, 100, 300, 1023, 1024, 1100)


@pytest.fixture(scope="module", autouse=True)
def jax_native_factorizer():
    # the JAX package's factorizer is one of the references; it must build
    assert jax_native_lyndon.available(), "the JAX package's native library does not build"


def _texts(rng, alphabet: bytes, widths, per_width: int = 2) -> list[str]:
    lut = np.frombuffer(alphabet, np.uint8)
    return [lut[rng.integers(0, len(lut), size=w)].tobytes().decode()
            for w in widths for _ in range(per_width)]


def test_alg_ids_equal_jax():
    assert native_lyndon.ALG_IDS == jax_native_lyndon.ALG_IDS


@pytest.mark.parametrize("alphabet", list(ALPHABETS))
@pytest.mark.parametrize("family", FAMILIES)
def test_native_equals_scalar_model_and_jax(family, alphabet):
    rng = np.random.default_rng(FAMILIES.index(family) * 10 + list(ALPHABETS).index(alphabet))
    texts = _texts(rng, ALPHABETS[alphabet], WIDTHS)
    got = native_lyndon.factorize_batch_native(texts, family)
    assert got == [scalar_lengths(t, family) for t in texts]
    assert got == jax_native_lyndon.factorize_batch_native(texts, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_flat_entry_point_takes_overlapping_rows(family):
    """``factorize_flat`` reads rows of a stream in place, overlapping as
    shift windows do, in any order, and gives each row's lengths."""
    rng = np.random.default_rng(5)
    text = _texts(rng, b"ACGTN", [1500], 1)[0]
    flat = np.frombuffer(text.encode(), np.uint8)
    starts = np.array([700, 0, 1, 2, 400, 400, 1499], np.int64)
    lengths = np.array([800, 100, 100, 1100, 0, 1024, 1], np.int32)
    lens, offsets = native_lyndon.factorize_flat(flat, starts, lengths, family)
    assert offsets[0] == 0 and offsets[-1] == len(lens) and lens.dtype == np.int32
    for b, (s, n) in enumerate(zip(starts, lengths)):
        assert lens[offsets[b] : offsets[b + 1]].tolist() == scalar_lengths(text[s : s + n],
                                                                           family)


@pytest.mark.parametrize("family", FAMILIES)
def test_empty_row_has_no_factors(family):
    # never hand "" to the scalar ICFL model: it does not return
    assert native_lyndon.factorize_batch_native([""], family) == [[]]
    assert native_lyndon.factorize_batch_native(["", "ACGT", ""], family)[::2] == [[], []]
    lens, offsets = native_lyndon.factorize_flat(np.zeros(0, np.uint8), np.zeros(0, np.int64),
                                                 np.zeros(0, np.int32), family)
    assert len(lens) == 0 and offsets.tolist() == [0]


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown factorization"):
        native_lyndon.factorize_batch_native(["ACGT"], "LYNDON")


@pytest.mark.parametrize("start,length", [(-1, 2), (3, 2), (0, -1)])
def test_rows_outside_the_stream_raise(start, length):
    flat = np.frombuffer(b"ACGT", np.uint8)
    with pytest.raises(ValueError, match="inside the stream"):
        native_lyndon.factorize_flat(flat, np.array([0, start]), np.array([1, length]), "CFL")


def test_scalar_rows_use_the_native_factorizer(monkeypatch, capsys):
    """``scalar_rows`` counts its rows, names its host in its span, and
    gives the scalar model's lengths."""
    rng = np.random.default_rng(3)
    text = _texts(rng, b"ACGT", [3000], 1)[0]
    flat = np.frombuffer(text.encode(), np.uint8)
    starts = np.array([0, 1000, 500], np.int64)
    lengths = np.array([2000, 1100, 50], np.int32)
    monkeypatch.setattr(trace_mod, "_ENABLED", True)
    monkeypatch.setitem(fingerprint.SCALAR_ROWS, "wide", 0)
    got = scalar_rows(flat, starts, lengths, [2, 0], "ICFL_COMB", "wide")
    assert fingerprint.SCALAR_ROWS["wide"] == 2
    assert got == {b: scalar_lengths(text[starts[b] : starts[b] + lengths[b]], "ICFL_COMB")
                   for b in (2, 0)}
    spans = [line for line in capsys.readouterr().err.splitlines() if "scalar-rows:" in line]
    assert len(spans) == 1 and "scalar-rows:wide" in spans[0]
    assert "rows=2" in spans[0] and "host=native" in spans[0]
    assert scalar_rows(flat, starts, lengths, [], "ICFL_COMB", "wide") == {}


@pytest.mark.parametrize("family", ["ICFL_COMB", "CFL_ICFL-10", "ICFL"])
def test_generalized_fingerprint_split_2000_equals_jax_cli(tmp_path, monkeypatch, family):
    """``fingerprint --type generalized --split 2000``: every chunk of 2000
    goes to the host factorizer (the last of each read, under the card's
    bound, to the card's plain version here); both CLIs print the same."""
    rng = np.random.default_rng(21)
    seqs = _texts(rng, b"ACGT", [5000, 4100, 2000, 900], 1)
    fasta = "".join(f">r{i} g{i}\n{s}\n" for i, s in enumerate(seqs))
    chunks = [min(2000, len(s) - i) for s in seqs for i in range(0, len(s), 2000)]
    monkeypatch.setattr(fingerprint, "SCALAR_ROWS", {"wide": 0, "ok_false": 0})
    for tag, main, extra in (("p", port_main, ["--device", "cpu"]), ("j", jax_main, [])):
        (tmp_path / tag).mkdir()
        (tmp_path / tag / "r.fa").write_text(fasta)
        assert main(["fingerprint", "--type", "generalized", "--split", "2000", "--fasta",
                     "r.fa", "--type_factorization", family, "--rev_comb", "true",
                     "--path", str(tmp_path / tag), *extra]) == 0
    # --rev_comb true: each read's forward and reverse-complement lines
    assert fingerprint.SCALAR_ROWS == {
        "wide": 2 * sum(1 for n in chunks if n > MAX_ICFL_WIDTH), "ok_false": 0}
    for name in (f"fingerprint_{family}.txt", f"fact_fingerprint_{family}.txt"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
