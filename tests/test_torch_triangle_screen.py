"""Port: the `triangle` and `screen` verbs, byte for byte against the JAX package's CLI.

Small inputs made with numpy from a seed go through ``python -m fpmash_tpu``
and ``python -m fpmash_tpu_torch ... --device cpu`` (the kernels' plain
versions), and the standard output must be the same bytes:

* ``triangle``: Phylip, ``-E``, ``-d``, ``-v`` with ``-C``, 32-bit hashes
  (``-k 15``), a sketch whose lists repeat hashes (the walk's route), and
  ``-fp`` over the DNA3 fingerprints and over 70 fingerprint references
  (the JAX package's batched positional route);
* ``screen``: streaming, ``-w``, ``-s``, ``-i``, ``-v``, ``-k 16`` (32-bit
  hashes from K8's route), an amino-acid sketch against nucleotide reads,
  and ``-fp``.

The reference goldens ``screen_ref.txt`` and ``genomes.dist`` hold through
the port on the CPU, and the distinct k-mer counts of ``screen``'s query
side equal ``np.unique`` of the JAX package's k-mer pool.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models import sketch as port_sketch

CPU = torch.device("cpu")


def _dna(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=n)])


def _mutate(rng, seq, rate):
    s = np.array(list(seq))
    hit = rng.random(len(s)) < rate
    s[hit] = np.array(list("ACGT"))[rng.integers(0, 4, size=int(hit.sum()))]
    return "".join(s)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Genomes (g2 is g1 with 3 % substitutions), reads of g1 and g2, 70
    fingerprint references, a protein and a mixture holding its coding
    sequence, and a sketch whose lists repeat hashes."""
    from fpmash_tpu.cli import main as jax_main

    rng = np.random.default_rng(404)
    d = tmp_path_factory.mktemp("world")
    g1 = _dna(rng, 3000)
    genomes = [("g1", g1), ("g2", _mutate(rng, g1, 0.03)), ("g3", _dna(rng, 3000)),
               ("g4", g1[:1500])]
    with open(d / "g.fa", "w") as fh:
        for name, seq in genomes:
            fh.write(f">{name} genome {name}\n{seq}\n")
    with open(d / "r.fq", "w") as fh:
        for i in range(300):
            src = genomes[i % 2][1]
            p = int(rng.integers(0, len(src) - 100))
            fh.write(f"@q{i} read\n{_mutate(rng, src[p:p + 100], 0.01)}\n+\n{'I' * 100}\n")
    with open(d / "fp.txt", "w") as fh:
        for i in range(70):
            for _ in range(int(rng.integers(1, 4))):
                fh.write(f"f{i} " + " ".join(map(str, rng.integers(1, 4, size=4))) + "\n")

    aas = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    prot = "".join(aas[rng.integers(0, 20, size=150)])
    (d / "p.faa").write_text(f">target t\n{prot}\n>decoy d\n{''.join(aas[rng.integers(0, 20, 150)])}\n")
    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT", "G": "GGT", "H": "CAT",
             "I": "ATT", "K": "AAA", "L": "CTT", "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA",
             "R": "CGT", "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    cds = "".join(codon[a] for a in prot)
    (d / "mix.fa").write_text(f">mix m\n{_dna(rng, 200)}{cds.lower()}{_dna(rng, 200)}\n")

    with contextlib.redirect_stderr(io.StringIO()):
        for opts, out in (([], "refs"), (["-k", "16"], "refs16"), (["-k", "15"], "refs15")):
            assert jax_main(["sketch", str(d / "g.fa"), "-i", "-s", "200", *opts,
                             "-o", str(d / out)]) == 0
        assert jax_main(["sketch", str(d / "p.faa"), "-a", "-i", "-s", "40",
                         "-o", str(d / "prot")]) == 0
        assert jax_main(["sketch", "-fp", str(d / "fp.txt"), "-o", str(d / "fpref")]) == 0

    reps = port_sketch.sketch_from_arrays(
        dict(kmer_size=21, sketch_size=50),
        [dict(name=f"x{i}", comment=f"c{i}", length=1000 + i,
              hashes=np.sort(rng.integers(0, 60, size=int(rng.integers(0, 50)))).astype(np.uint64))
         for i in range(6)])
    reps.write_msh(str(d / "repeats.msh"))

    top = np.uint64(2**64 - 1)
    pads = []
    for i in range(6):
        h = np.unique(rng.integers(0, 60, size=int(rng.integers(1, 40)))).astype(np.uint64)
        pads.append(dict(name=f"y{i}", comment=f"e{i}", length=900 + i,
                         hashes=np.append(h, top) if i % 3 else h))
    port_sketch.sketch_from_arrays(dict(kmer_size=21, sketch_size=50), pads).write_msh(
        str(d / "pad.msh"))
    return d


def _same_output(argv):
    """The standard output of both CLIs on ``argv``; asserts they agree."""
    from fpmash_tpu.cli import main as jax_main

    outs = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            assert main([*argv, *extra]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0]
    return outs[0]


@pytest.mark.parametrize("opts,inputs", [
    ([], ["g.fa"]),
    (["-E"], ["g.fa"]),
    (["-d", "0.05"], ["refs.msh"]),
    (["-v", "1e-30", "-C"], ["refs.msh"]),
    (["-k", "15", "-E"], ["g.fa"]),
    ([], ["repeats.msh"]),
    (["-E"], ["repeats.msh"]),
    ([], ["pad.msh"]),
    (["-E"], ["pad.msh"]),
], ids=["phylip", "edge", "max-distance", "max-pvalue-comment", "k15", "repeats-phylip",
        "repeats-edge", "pad-phylip", "pad-edge"])
def test_triangle_matches_jax(world, opts, inputs):
    out = _same_output(["triangle", *[str(world / f) for f in inputs], *opts])
    assert len(out.splitlines()) > 1


@pytest.mark.parametrize("opts,inputs", [
    ([], "DNA3"), (["-E"], "DNA3"), ([], "fp.txt"), (["-d", "0.6", "-C"], "fp.txt"),
    (["-v", "0.5"], "fpref.msh"),
], ids=["dna3-phylip", "dna3-edge", "70-phylip", "70-max-distance", "msh-max-pvalue"])
def test_triangle_fp_matches_jax(world, golden_dir, opts, inputs):
    path = golden_dir / "cfl" / "DNA3-CFL.txt" if inputs == "DNA3" else world / inputs
    _same_output(["triangle", "-fp", str(path), *opts])


def test_triangle_takes_the_sorted_comparison_on_strict_lists(world, monkeypatch):
    """Classic sketches (strictly increasing lists) go through K9; the
    sketch with repeated hashes, and the strictly increasing one whose
    lists end in 2^64 - 1 (K9's pad), through the walk K2."""
    from fpmash_tpu_torch.ops import compare_cuda, walk_cuda

    calls = []
    for mod, name in ((compare_cuda, "pairwise_common_denom"), (walk_cuda, "pairwise_walk")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main(["triangle", str(world / "refs.msh"), "--device", "cpu"]) == 0
        assert calls == ["pairwise_common_denom"]
        assert port_main(["triangle", str(world / "repeats.msh"), "--device", "cpu"]) == 0
        assert port_main(["triangle", str(world / "pad.msh"), "--device", "cpu"]) == 0
    assert calls == ["pairwise_common_denom", "pairwise_walk", "pairwise_walk"]


@pytest.mark.parametrize("ref,opts", [
    ("refs.msh", []), ("refs.msh", ["-w"]), ("refs.msh", ["-s"]), ("refs.msh", ["-i", "0.9"]),
    ("refs.msh", ["-v", "1e-20", "-w", "-s"]), ("refs16.msh", []), ("refs15.msh", ["-w"]),
], ids=["plain", "winner", "saturation", "identity", "pvalue-winner-saturation", "k16", "k15"])
def test_screen_streaming_matches_jax(world, ref, opts):
    out = _same_output(["screen", str(world / ref), str(world / "r.fq"), str(world / "g.fa"),
                        *opts])
    assert "g1" in out


def test_screen_amino_acid_sketch_matches_jax(world):
    out = _same_output(["screen", str(world / "prot.msh"), str(world / "mix.fa")])
    assert "target" in out


@pytest.mark.parametrize("opts", [[], ["-s"], ["-i", "0.5"]], ids=["plain", "saturation",
                                                                  "identity"])
def test_screen_fp_matches_jax(world, opts):
    _same_output(["screen", "-fp", str(world / "fpref.msh"), str(world / "fp.txt"), *opts])


@pytest.mark.parametrize("k", [16, 21, 9], ids=["k16-32bit", "k21", "k9-32bit"])
def test_kmer_distinct_counts_match_np_unique_of_jax_pool(k):
    """screen's and taxscreen's query side (``distinct_kmer_counts`` of the
    records' stream): every distinct hash and its multiplicity, with
    invalid characters, record separators and duplicated records; k <= 16
    collapses the hashes to 32 bits before counting."""
    import fpmash_tpu.models.sketch as jax_sketch

    rng = np.random.default_rng(k)
    seqs = ["".join(np.array(list("ACGTN"))[rng.choice(5, 3000, p=[0.24] * 4 + [0.04])]),
            _dna(rng, 2000).lower()]
    seqs.append(seqs[1][:1200])
    want_v, want_c = np.unique(
        np.asarray(jax_sketch._kmer_hash_pool(seqs, jax_sketch.SketchParams(kmer_size=k), "auto"),
                   np.uint64), return_counts=True)
    p = port_sketch.SketchParams(kmer_size=k)
    stream = torch.from_numpy(port_sketch._blob(seqs, k).copy())
    values, counts = port_sketch.distinct_kmer_counts(
        stream, np.array([len(s) for s in seqs], np.int64), p, (CPU,))
    assert values.dtype == counts.dtype == torch.int64 and values.device == CPU
    got_v, got_c = values.numpy().view(np.uint64), counts.numpy()
    assert np.array_equal(got_v, want_v) and np.array_equal(got_c, want_c)
    assert (got_c > 1).any()
    if not p.use64:
        assert int(got_v.max()) < 2**32


@pytest.fixture(scope="module")
def genomes_msh(golden_dir, tmp_path_factory):
    """The three genome sketches of the reference's goldens as one ``.msh``."""
    sk = port_sketch.Sketch()
    for i in (1, 2, 3):
        sk.load_msh(str(golden_dir / "mash_ref" / f"genome{i}.fna.msh"))
        sk.references[-1].name = f"genome{i}.fna"
    out = tmp_path_factory.mktemp("genomes") / "genomes.msh"
    sk.write_msh(str(out))
    return str(out)


def test_screen_golden(golden_dir, genomes_msh, capsys):
    reads = [str(golden_dir / "new_data" / f"reads{i}.fastq") for i in (1, 2)]
    assert port_main(["screen", genomes_msh, *reads, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == (golden_dir / "mash_ref" / "screen_ref.txt").read_text()


def test_genomes_dist_golden_through_the_sorted_comparison(golden_dir, genomes_msh, capsys,
                                                           monkeypatch):
    from fpmash_tpu_torch.ops import compare_cuda

    calls = []
    orig = compare_cuda.pairwise_common_denom
    monkeypatch.setattr(compare_cuda, "pairwise_common_denom",
                        lambda *a: calls.append(1) or orig(*a))
    capsys.readouterr()
    assert port_main(["dist", genomes_msh, str(golden_dir / "new_data" / "reads.msh"),
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out == (golden_dir / "mash_ref" / "genomes.dist").read_text()
    assert calls == [1]
