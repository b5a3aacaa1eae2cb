"""Port: all ten factorization families, and the ``fingerprint`` verb, against the JAX package.

Factor lengths from ``factor_words_plain`` (the plain composition that
kernels K3/K14 are held against) are compared three ways for every family:
with the JAX package's ``factor_lengths_device`` on the CPU (XLA), with
``fpmash_tpu.scalar.lyndon.FACTORIZATIONS``, and with the port's own scalar
copy.  Rows: random ACGT rows of 100, rows of 1-99, empty rows, rows with
N, homopolymers, periodic rows and a few rows of 300-1 000 characters, made
with numpy from a seed.  Exact (the JAX route is held at the rows of up to 100).  Then the port's ``fingerprint`` verb on a
prefix of the lyn2vec golden reads must equal the goldens byte for byte,
``fact_`` files included.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpmash_tpu.ops.factorize import factor_lengths_device as jax_factor_lengths
from fpmash_tpu.ops.lyndon import encode_batch as jax_encode_batch
from fpmash_tpu.scalar.lyndon import FACTORIZATIONS as JAX_FACTORIZATIONS
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models.fingerprint import lengths_from_words, window_stream
from fpmash_tpu_torch.ops.factorize import FAMILY_PLANS, factorize_windows_device
from fpmash_tpu_torch.ops.icfl_cuda import factor_words_plain
from fpmash_tpu_torch.scalar.lyndon import FACTORIZATIONS

MARKERS = ("<<", ">>")


def _texts() -> list[str]:
    rng = np.random.default_rng(2024)

    def rand(alphabet: bytes, n: int) -> str:
        lut = np.frombuffer(alphabet, np.uint8)
        return lut[rng.integers(0, len(lut), size=n)].tobytes().decode()

    texts = [rand(b"ACGT", 100) for _ in range(24)]
    texts += [rand(b"ACGT", int(m)) for m in rng.integers(1, 100, size=6)]
    texts += ["", ""]
    texts += [rand(b"ACGTACGTN", 100) for _ in range(6)]
    texts += ["A" * 100, "T" * 100, "G" * 57, ("ACACGTGT" * 13)[:100], "AC" * 50,
              "ACGT" * 25, "CCGCG" * 20]
    texts += [rand(b"ACGT", 733), rand(b"ACGTN", 1000), ("ACACGTGT" * 50)[:397]]
    return texts


def _scalar(table, family: str, text: str) -> list[int]:
    return [len(f) for f in table[family](text) if f not in MARKERS] if text else []


@pytest.fixture(scope="module")
def texts():
    return _texts()


@pytest.mark.parametrize("family", list(FAMILY_PLANS))
def test_family_lengths_three_ways(texts, family):
    flat, starts, lengths, _ = window_stream(texts, shift=False)
    words, ok = factor_words_plain(torch.from_numpy(flat), torch.from_numpy(starts),
                                   torch.from_numpy(lengths), family)
    assert bool(ok.all())
    mine = [ls.tolist() for ls in lengths_from_words(words.numpy(), lengths)]

    # the JAX device route at the shift width (its XLA loops on the CPU
    # cost time in proportion to the widest row)
    narrow = [len(t) <= 100 for t in texts]
    arr, lens = jax_encode_batch([t for t, keep in zip(texts, narrow) if keep])
    fac_len, fac_count, jax_ok = (np.asarray(a) for a in jax_factor_lengths(
        jnp.asarray(arr), jnp.asarray(lens), family))
    assert jax_ok.all()
    jax_lengths = iter(fac_len[r, : fac_count[r]].tolist() for r in range(len(arr)))
    for b, text in enumerate(texts):
        want = _scalar(JAX_FACTORIZATIONS, family, text)
        assert mine[b] == want, (family, b)
        assert _scalar(FACTORIZATIONS, family, text) == want, (family, b)
        if narrow[b]:
            assert next(jax_lengths) == want, (family, b)
    assert factorize_windows_device(texts, family, torch.device("cpu")) == mine


def _prefix_fasta(golden_dir, tmp_path, n_records: int):
    lines = (golden_dir / "lyn2vec_basic" / "example_transcripts_genes.fa").read_text().splitlines()
    heads = [i for i, line in enumerate(lines) if line.startswith(">")] + [len(lines)]
    path = tmp_path / "prefix.fa"
    path.write_text("\n".join(lines[: heads[n_records]]) + "\n")
    return path


def _golden(golden_dir, name):
    plain = golden_dir / "lyn2vec_basic" / name
    if plain.exists():
        return plain.read_text()
    packed = golden_dir / "lyn2vec_basic" / f"{name}.gz"
    if packed.exists():
        with gzip.open(packed, "rt") as fh:
            return fh.read()
    return None


@pytest.mark.parametrize("family", list(FAMILY_PLANS))
def test_fingerprint_verb_matches_golden_prefix(golden_dir, tmp_path, family):
    """The uncompressed goldens are ``--rev_comb false`` runs, the gzipped ones
    ``--rev_comb true`` runs; each starts with the first reads' lines."""
    fasta = _prefix_fasta(golden_dir, tmp_path, 3)
    rev = "false" if (golden_dir / "lyn2vec_basic" / f"fingerprint_{family}.txt").exists() else "true"
    assert port_main(["fingerprint", "--path", str(tmp_path), "--fasta", fasta.name,
                      "--type_factorization", family, "--rev_comb", rev, "--device", "cpu"]) == 0
    mine = (tmp_path / f"fingerprint_{family}.txt").read_text()
    golden = _golden(golden_dir, f"fingerprint_{family}.txt")
    assert mine.count("\n") > 1000
    assert golden.startswith(mine)
    gold_fact = _golden(golden_dir, f"fact_fingerprint_{family}.txt")
    if gold_fact is not None:
        mine_fact = (tmp_path / f"fact_fingerprint_{family}.txt").read_text()
        assert gold_fact.startswith(mine_fact)


def test_fingerprint_generalized_and_no_shift_match_jax(tmp_path):
    """The generalized mode (chunks, ``_0``/``_1`` lines) and ``--shift
    no_shift`` through both CLIs, with a read wider than the card's ICFL
    bound (the scalar route)."""
    from fpmash_tpu.cli import main as jax_main

    rng = np.random.default_rng(9)
    lut = np.frombuffer(b"ACGTACGTN", np.uint8)
    seqs = [lut[rng.integers(0, len(lut), size=int(m))].tobytes().decode()
            for m in (650, 120, 1100, 40)]
    (tmp_path / "r.fa").write_text("".join(f">r{i} g{i}\n{s}\n" for i, s in enumerate(seqs)))
    runs = [["--type", "generalized", "--rev_comb", "true"],
            ["--type", "basic", "--shift", "no_shift"]]
    for family in ("ICFL_COMB", "CFL_ICFL-10", "CFL"):
        for opts in runs:
            args = ["fingerprint", "--fasta", "r.fa", "--type_factorization", family, *opts]
            for tag, main, extra in (("p", port_main, ["--device", "cpu"]),
                                     ("j", jax_main, ["--backend", "scalar"])):
                (tmp_path / tag).mkdir(exist_ok=True)
                (tmp_path / tag / "r.fa").write_text((tmp_path / "r.fa").read_text())
                assert main([*args, "--path", str(tmp_path / tag), *extra]) == 0
            for name in (f"fingerprint_{family}.txt", f"fact_fingerprint_{family}.txt"):
                assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text()
