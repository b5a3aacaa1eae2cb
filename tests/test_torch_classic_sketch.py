"""Port: the classic k-mer MinHash sketch, its routes and its CLI, vs the JAX package.

* The direct route (chunks sketched by ``classic_sketch_device``, merged on
  the host), shrunk to chunks of 8 192 and 32 768 bases so that it takes
  both K6 and K5 and several chunks, against the JAX package's pool path
  (its ``_kmer_hash_pool`` and ``bottom_k_host``): with counts, with
  ``min_cov`` 2, with a chunk that only the full per-chunk hash can fill,
  and with no valid window at all.
* The reference goldens: ``sketch -r -I reads reads1.fastq reads2.fastq``
  equals ``reads.msh``, and ``dist`` of the three genome sketches against
  it prints ``genomes.dist``.
* The CLI: ``.msh`` bytes and ``dist`` lines equal to ``python -m
  fpmash_tpu``'s for ``-k 15`` (32-bit hashes), ``-i``, ``-b``, ``-c``,
  ``-M`` on a ``.msh``, ``-a`` and ``dist`` of sequence files.

Everything runs on the CPU through the kernels' plain versions; the route
taken does not depend on the device.  Hashes, counts and lengths are
integers: the comparisons are exact.
"""

import contextlib
import dataclasses
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fpmash_tpu.models.sketch as jax_sketch
import fpmash_tpu_torch.models.sketch as port_sketch
from fpmash_tpu.cli import main as jax_main
from fpmash_tpu.ops.bottomk import bottom_k_host
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.ops import kmers_cuda
from fpmash_tpu_torch.utils.msh import read_msh

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _dna(rng, n, alphabet="ACGT"):
    return "".join(np.array(list(alphabet))[rng.integers(0, len(alphabet), size=n)])


def _jax_pool_sketch(seq, s, min_cov=1, **params):
    """The JAX package's pool path: every hash, then the numpy bottom-k."""
    p = jax_sketch.SketchParams(sketch_size=s, **params)
    return bottom_k_host(jax_sketch._kmer_hash_pool([seq], p, "auto"), s, min_cov)


def _port_direct(seq, **params):
    return port_sketch._classic_sketch_direct([seq], port_sketch.SketchParams(**params), (CPU,))


@pytest.fixture
def routes(monkeypatch):
    """Which hash kernels the port's routes called (plain versions on the CPU)."""
    calls = []
    for name in ("kmer_hashes_planes", "kmer_hashes_masked_planes", "kmer_hashes_topk8_planes"):
        orig = getattr(kmers_cuda, name)
        monkeypatch.setattr(kmers_cuda, name,
                            lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("chunk,s,kernel", [(8192, 64, "kmer_hashes_masked_planes"),
                                            (1 << 15, 16, "kmer_hashes_topk8_planes")])
def test_direct_route_multichunk_matches_jax_pool(monkeypatch, routes, chunk, s, kernel):
    """Several chunks with duplicated k-mers split across them; without and
    with counts (-M), which must add up across chunks."""
    monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", chunk)
    rng = np.random.default_rng(41)
    seq = _dna(rng, 5 * chunk // 2)
    seq = seq[: chunk // 2] + seq[: chunk // 2] + seq[chunk:]
    want_v, want_c = _jax_pool_sketch(seq, s)
    assert len(want_v) == s

    got = _port_direct(seq, sketch_size=s)
    assert got is not None and kernel in routes
    assert "kmer_hashes_planes" not in routes  # no chunk needed the full hash
    assert np.array_equal(got[0], want_v) and (got[1] == 1).all()  # counts unused: ones

    got = _port_direct(seq, sketch_size=s, counts=True)
    assert np.array_equal(got[0], want_v) and np.array_equal(got[1], want_c)
    assert (want_c > 1).any()


def test_direct_reads_route_min_cov2_matches_jax_pool(monkeypatch, routes):
    """min_cov 2: collect-all chunks, counts summed, the filter after the
    merge; copies of every k-mer of ``base`` lie in different chunks."""
    monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 8192)
    rng = np.random.default_rng(47)
    base = _dna(rng, 9000)
    seq = base + _dna(rng, 3000) + base
    params = dict(sketch_size=64, min_cov=2, reads=True, counts=True)
    want_v, want_c = _jax_pool_sketch(seq, 64, min_cov=2)
    assert len(want_v) == 64
    got = _port_direct(seq, **params)
    assert got is not None and "kmer_hashes_masked_planes" in routes
    assert np.array_equal(got[0], want_v) and np.array_equal(got[1], want_c)

    # few k-mers reach min_cov: the ladder ends saturated or hands the input
    # to the pool path; either way the sketch is exact
    seq2 = _dna(rng, 20000)
    p = port_sketch.SketchParams(**params)
    got2 = port_sketch._sketch_pools([seq2], p, (CPU,))
    want2 = _jax_pool_sketch(seq2, 64, min_cov=2)
    assert np.array_equal(got2[0], want2[0]) and np.array_equal(got2[1], want2[1])


def test_direct_route_tail_sliver_and_chunk_pool(monkeypatch, routes):
    """A chunk of almost only N fails the boost ladder and is hashed in full;
    a tail shorter than k is skipped; an all-N input gives an empty sketch."""
    monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 8192)
    rng = np.random.default_rng(43)
    step = 8192 - 20
    seq = _dna(rng, step) + "N" * (step - 40) + _dna(rng, 40) + _dna(rng, 19)
    got = _port_direct(seq, sketch_size=64)
    assert "kmer_hashes_planes" in routes  # the per-chunk exact hash
    assert np.array_equal(got[0], _jax_pool_sketch(seq, 64)[0])
    got = _port_direct("N" * 20000, sketch_size=64)
    assert len(got[0]) == 0 and len(got[1]) == 0


def test_sequences_sketch_matches_jax_and_scalar_model():
    """init_from_sequences on records with lower case, N and short records,
    merged and per record, for k 21 (64-bit) and 12 (32-bit), against the
    JAX package (pool path) and the scalar model of the k-mer pool."""
    rng = np.random.default_rng(3)
    records = [(f"r{i}", f"c{i}", _dna(rng, int(n), "ACGTACGTacgtN"))
               for i, n in enumerate([3000, 20, 700, 5, 1500])]
    for k, merge in ((21, True), (12, False), (21, False)):
        port = port_sketch.Sketch(port_sketch.SketchParams(kmer_size=k, sketch_size=300))
        port.init_from_sequences(records, name="x" if merge else "", merge=merge, devices=(CPU,))
        jax = jax_sketch.Sketch(jax_sketch.SketchParams(kmer_size=k, sketch_size=300))
        jax.init_from_sequences(records, name="x" if merge else "", merge=merge)
        assert len(port) == len(jax) == (1 if merge else sum(len(r[2]) >= k for r in records))
        for a, b in zip(port.references, jax.references, strict=True):
            assert (a.name, a.comment, a.length) == (b.name, b.comment, b.length)
            assert np.array_equal(a.hashes, b.hashes)
    p = port_sketch.SketchParams(kmer_size=15)
    seqs = [r[2] for r in records]
    pool = port_sketch._kmer_hash_pool(seqs, p, (CPU,)).numpy().view(np.uint64)
    assert np.array_equal(pool, port_sketch._kmer_hash_pool_scalar(seqs, p))


@pytest.fixture(scope="module")
def port_reads_msh(golden_dir, tmp_path_factory):
    """``sketch -r -I reads reads1.fastq reads2.fastq --device cpu``."""
    out = tmp_path_factory.mktemp("reads") / "reads"
    reads = [str(golden_dir / "new_data" / f"reads{i}.fastq") for i in (1, 2)]
    assert port_main(["sketch", "-r", "-I", "reads", *reads, "-o", str(out),
                      "--device", "cpu"]) == 0
    return pathlib.Path(f"{out}.msh")


def test_reads_golden(port_reads_msh, golden_dir):
    mine = read_msh(str(port_reads_msh)).references
    gold = read_msh(str(golden_dir / "new_data" / "reads.msh")).references
    assert len(mine) == len(gold) == 1
    m, g = mine[0], gold[0]
    assert m.name == g.name == "reads" and m.length == g.length == 502359
    assert np.array_equal(m.hashes64, g.hashes64)
    assert np.array_equal(m.counts32, g.counts32) and m.counts32_sorted
    # the golden's comment carries a stray \r from the reference's CRLF input
    assert m.comment == g.comment.replace("\r", "") == "[2000 seqs] SRR7885321.1 1 length=302 [...]"


def test_genomes_dist_golden(port_reads_msh, golden_dir, tmp_path, capsys):
    genomes = port_sketch.Sketch()
    for i in (1, 2, 3):
        genomes.load_msh(str(golden_dir / "mash_ref" / f"genome{i}.fna.msh"))
        genomes.references[-1].name = f"genome{i}.fna"
    genomes.write_msh(str(tmp_path / "genomes.msh"))
    capsys.readouterr()
    assert port_main(["dist", str(tmp_path / "genomes.msh"), str(port_reads_msh),
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out == (golden_dir / "mash_ref" / "genomes.dist").read_text()


def _fastq(path, rng, genome, n_reads, read_len, error=0.01):
    with open(path, "w") as fh:
        for i in range(n_reads):
            p = int(rng.integers(0, len(genome) - read_len))
            read = np.array(list(genome[p : p + read_len]))
            err = rng.random(read_len) < error
            read[err] = np.array(list("ACGT"))[rng.integers(0, 4, size=int(err.sum()))]
            fh.write(f"@q{i} sim {i}\n{''.join(read)}\n+\n{'I' * read_len}\n")


def _fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name} about {name}\n")
            for p in range(0, len(seq), 60):
                fh.write(seq[p : p + 60] + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(77)
    d = tmp_path_factory.mktemp("inputs")
    genome = _dna(rng, 4000)
    mutated = "".join(c if rng.random() > 0.05 else "ACGT"[rng.integers(0, 4)] for c in genome)
    _fasta(d / "a.fa", [("a1", genome[:2500]), ("a2", genome[2500:]), ("tiny", "ACGT")])
    _fasta(d / "b.fa", [("b1", mutated.lower()[:1800] + "NNNN" + mutated[1800:])])
    _fastq(d / "r.fq", rng, genome, 700, 100)
    protein = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[rng.integers(0, 20, size=900)])
    _fasta(d / "p.fa", [("p1", protein), ("p2", protein[::-1])])
    return d


@pytest.mark.parametrize("opts,files", [
    ([], ["a.fa", "b.fa"]),
    (["-k", "15", "-s", "400"], ["a.fa"]),
    (["-i", "-s", "200", "-S", "9"], ["a.fa"]),
    (["-r", "-b", "1M"], ["r.fq"]),
    (["-c", "2", "-s", "100"], ["r.fq"]),
    (["-r", "-m", "2", "-I", "reads", "-C", "sim"], ["r.fq"]),
    (["-n", "-Z", "-k", "17"], ["b.fa"]),
    (["-a"], ["p.fa"]),
], ids=["default", "k15-32bit", "individual", "bloom", "target-cov", "min-cov", "noncanonical",
        "amino"])
def test_sketch_cli_bytes_match_jax(inputs, tmp_path, opts, files):
    paths = [str(inputs / f) for f in files]
    assert port_main(["sketch", *paths, *opts, "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_main(["sketch", *paths, *opts, "-o", str(tmp_path / "j")]) == 0
    assert (tmp_path / "p.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    refs = read_msh(str(tmp_path / "p.msh")).references
    assert refs and all(sum(len(h) for h in (r.hashes32, r.hashes64) if h is not None)
                        for r in refs)


def test_sketch_counts_of_msh_input_match_jax(golden_dir, tmp_path):
    """``sketch -M reads.msh``: the counts of a loaded sketch are kept and
    written (they were dropped before ``Reference`` carried them)."""
    src = str(golden_dir / "new_data" / "reads.msh")
    assert port_main(["sketch", "-M", src, "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_main(["sketch", "-M", src, "-o", str(tmp_path / "j")]) == 0
    assert (tmp_path / "p.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    assert np.array_equal(read_msh(str(tmp_path / "p.msh")).references[0].counts32,
                          read_msh(src).references[0].counts32)

    jsk = jax_sketch.Sketch()
    jsk.load_msh(src)
    conv = port_sketch.sketch_from_arrays(
        dataclasses.asdict(jsk.params),
        [dict(name=r.name, comment=r.comment, length=r.length, hashes=r.hashes,
              counts=r.counts, counts_sorted=r.counts_sorted) for r in jsk.references],
    )
    conv.params.counts = True
    conv.write_msh(str(tmp_path / "conv.msh"))
    assert (tmp_path / "conv.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


@pytest.mark.parametrize("opts", [[], ["-t"], ["-k", "16", "-i"]], ids=["plain", "table", "k16-individual"])
def test_dist_of_sequence_files_matches_jax(inputs, golden_dir, capsys, opts):
    """``dist`` sketches sequence inputs on the fly (queries with the
    reference's parameters), also against a ``.msh`` reference."""
    for ref in (str(inputs / "a.fa"), str(golden_dir / "mash_ref" / "genome1.fna.msh")):
        args = ["dist", ref, str(inputs / "b.fa"), str(inputs / "r.fq"), *opts]
        capsys.readouterr()
        assert port_main([*args, "--device", "cpu"]) == 0
        port = capsys.readouterr().out
        assert jax_main(args) == 0
        assert port == capsys.readouterr().out and port


def test_port_cli_process_matches_jax_bytes(inputs, tmp_path):
    """``python -m fpmash_tpu_torch sketch`` in its own process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-m", "fpmash_tpu_torch", "sketch", str(inputs / "a.fa"), "-o", "port",
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    assert "Writing to port.msh..." in proc.stderr
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_main(["sketch", str(inputs / "a.fa"), "-o", str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port.msh").read_bytes() == (tmp_path / "jax.msh").read_bytes()
