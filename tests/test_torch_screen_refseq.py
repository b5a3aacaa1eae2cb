"""Port: ``screen`` of a read set against a sketch database shaped like Mash's
RefSeq one, held to the benchmark's plain reference and to the JAX package.

The database and the reads come from the benchmark's own generator
(``bench_port/generators/metagenome.py``) at a small size: 300 references,
of which 12 are sketches of generated 20 kb genomes in families of 4 and the
rest drawn bottom-s sketches, and 20 000 reads of 150 bases from 5 of the
genomes.  A second database adds copies of two genome sketches, one of the
same length and one longer, so that ``-w`` meets ties on identity.  The port
runs on the CPU (the kernels' plain versions) and must print the lines of
``bench_port/reference/screen.py`` and the JAX package's bytes; its query
stream (``models/sketch.record_stream``) must count the same k-mers as the
per-record path; and the membership test must bring back only the shared
counts, the hits and the query's ``s`` smallest values.
"""

import contextlib
import gzip
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from bench_port.checks import screen_lines
from bench_port.harness import spec
from bench_port.reference import screen as ref_screen
from bench_port.reference.msh_writer import msh_bytes
from fpmash_tpu_torch.cli import main as port_main
from fpmash_tpu_torch.models import sketch as port_sketch
from fpmash_tpu_torch.utils import trace as port_trace

CPU = torch.device("cpu")
K, S, SEED = 21, 1000, 42
PARAMS = {"kmer": K, "sketch_size": S, "hash_seed": SEED, "references": 300, "genomes": 12,
          "family_size": 4, "genome_length": 20000, "gc": [0.35, 0.65],
          "divergence": [0.01, 0.05], "distractor_length": [1000000, 10000000], "read_sets": 1,
          "reads": 20000, "read_length": 150, "substitution": 0.01, "present": 5,
          "abundance_sigma": 1.0, "quality": "I"}
BIG, CUT = 3000, 700  # references of the largest database; the sketch size of one that cuts


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The generated database, its copy with ties, the read set, and the
    reference's view of each."""
    d = tmp_path_factory.mktemp("refseq")
    pool = spec.module("generators", "metagenome").make(np.random.default_rng(2024), d, PARAMS)
    db, reads = pool.items
    # ties: genome sketches copied to the end, one as long, one longer
    genomes = [i for i, c in enumerate(db.comments) if "genome" in c][:2]
    starts = np.cumsum(db.seg_len) - db.seg_len
    extra = [(genomes[0], 0), (genomes[1], 1000)]
    names = db.headers + [f"copy{j}" for j in range(len(extra))]
    comments = db.comments + [f"copy of {db.headers[i]}" for i, _ in extra]
    lengths = np.append(db.lengths, [db.lengths[i] + more for i, more in extra])
    seg_len = np.append(db.seg_len, [db.seg_len[i] for i, _ in extra])
    hashes = np.concatenate([db.hashes] + [db.hashes[starts[i] : starts[i] + db.seg_len[i]]
                                           for i, _ in extra])
    (d / "ties.msh").write_bytes(msh_bytes(kmer=K, sketch_size=S, seed=SEED, alphabet="ACGT",
                                           canonical=True, names=names, comments=comments,
                                           lengths=lengths, hashes=hashes, seg_len=seg_len))
    # a few thousand references: the database and drawn bottom-s sketches
    _, more = spec.module("generators", "metagenome")._distractors(
        np.random.default_rng(7), BIG - len(db.headers), S, PARAMS["distractor_length"])
    big = (db.headers + [f"drawn{j}" for j in range(len(more))],
           db.comments + ["drawn sketch"] * len(more),
           np.append(db.lengths, np.full(len(more), 5000000)),
           np.concatenate([db.hashes, more.ravel()]),
           np.append(db.seg_len, np.full(len(more), S)))
    names_b, comments_b, lengths_b, hashes_b, seg_len_b = big
    (d / "big.msh").write_bytes(msh_bytes(kmer=K, sketch_size=S, seed=SEED, alphabet="ACGT",
                                          canonical=True, names=names_b, comments=comments_b,
                                          lengths=lengths_b, hashes=hashes_b,
                                          seg_len=seg_len_b))
    # lists longer than the header's sketch size: loading cuts each to it
    (d / "trunc.msh").write_bytes(msh_bytes(kmer=K, sketch_size=CUT, seed=SEED, alphabet="ACGT",
                                            canonical=True, names=db.headers,
                                            comments=db.comments, lengths=db.lengths,
                                            hashes=db.hashes, seg_len=db.seg_len))
    cut = np.minimum(db.seg_len, CUT)
    cut_hashes = np.concatenate([db.hashes[a : a + c] for a, c in zip(starts, cut)])
    (rows,) = reads.seqs
    return {
        "big.msh": ref_screen.database(hashes_b, seg_len_b, lengths_b, names_b, comments_b,
                                       64, CPU),
        "trunc.msh": ref_screen.database(cut_hashes, cut, db.lengths, db.headers, db.comments,
                                         64, CPU),
        "dir": d,
        "refseq.msh": ref_screen.database(db.hashes, db.seg_len, db.lengths, db.headers,
                                          db.comments, 64, CPU),
        "ties.msh": ref_screen.database(hashes, seg_len, lengths, names, comments, 64, CPU),
        "reads": reads.path,
        "query": ref_screen.query(torch.from_numpy(rows), K, SEED, 64),
    }


def _port(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert port_main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


@pytest.mark.parametrize("db,opts", [
    ("refseq.msh", []), ("refseq.msh", ["-w"]), ("refseq.msh", ["-i", "0.85"]),
    ("refseq.msh", ["-v", "1e-40"]), ("refseq.msh", ["-w", "-i", "0.8", "-v", "1e-20"]),
    ("ties.msh", ["-w"]), ("ties.msh", []), ("trunc.msh", ["-w"]), ("trunc.msh", []),
], ids=["plain", "winner", "identity", "pvalue", "winner-identity-pvalue", "ties-winner",
        "ties-plain", "trunc-winner", "trunc-plain"])
def test_screen_matches_the_plain_reference(world, db, opts):
    got = screen_lines.parse(_port(["screen", *opts, str(world["dir"] / db),
                                    str(world["reads"])]).encode())
    ident = float(opts[opts.index("-i") + 1]) if "-i" in opts else 0.0
    pval = float(opts[opts.index("-v") + 1]) if "-v" in opts else 1.0
    want = ref_screen.screen(world[db], world["query"], K, CUT if db == "trunc.msh" else S,
                             winner="-w" in opts, min_identity=ident, max_pvalue=pval)
    assert len(want) >= 3
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g[1:5] == w[1:5]
        assert g[5] == pytest.approx(w[5], rel=screen_lines.REL_TOL)
        assert g[6] == pytest.approx(w[6], rel=screen_lines.REL_TOL, abs=1e-300)
    if db == "ties.msh":
        names = [g[0] for g in got]
        if "-w" in opts:  # the copy of the same length loses to the original, the longer wins
            assert "copy0" not in names and "copy1" in names
        else:
            assert {"copy0", "copy1"} <= set(names)


@pytest.mark.parametrize("db,opts", [("refseq.msh", ["-w"]), ("ties.msh", ["-w", "-s"]),
                                     ("ties.msh", ["-i", "0.9"]), ("trunc.msh", ["-w"])],
                         ids=["winner", "ties-winner-saturation", "ties-identity",
                              "trunc-winner"])
def test_screen_matches_jax_byte_for_byte(world, db, opts):
    from fpmash_tpu.cli import main as jax_main

    argv = ["screen", *opts, str(world["dir"] / db), str(world["reads"])]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert jax_main(argv) == 0
    assert _port(argv) == out.getvalue() != ""


def test_record_stream_counts_what_the_record_path_counts(tmp_path):
    """Plain FASTA and FASTQ through the native reader, a ``.gz`` through the
    Python one, records shorter than k, an empty one, N, lower case: the one
    stream's distinct hashes and counts are those of the per-record path."""
    rng = np.random.default_rng(7)
    dna = lambda n, a="ACGT": "".join(np.array(list(a))[rng.integers(0, len(a), n)])  # noqa: E731
    fa = [("a", dna(400)), ("short", dna(K - 1)), ("b", dna(300, "ACGTN").lower()),
          ("empty", ""), ("c", dna(250))]
    fq = [(f"r{i}", dna(int(rng.integers(10, 160)))) for i in range(40)]
    (tmp_path / "x.fa").write_text("".join(f">{n} c\n{s}\n" for n, s in fa))
    (tmp_path / "y.fq").write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in fq))
    with gzip.open(tmp_path / "z.fa.gz", "wt") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in fq[:5]))
    paths = [str(tmp_path / f) for f in ("x.fa", "y.fq", "z.fa.gz")]
    p = port_sketch.SketchParams()
    stream, lengths = port_sketch.record_stream(paths, K, CPU)
    assert len(lengths) == len(fa) + len(fq) + 5
    assert int(lengths.sum()) == stream.numel() - (K - 1) * (len(lengths) - 1)
    values, counts = port_sketch.distinct_kmer_counts(stream, lengths, p, (CPU,))
    seqs = [s for _, s in fa + fq + fq[:5] if len(s) >= K]
    blob = torch.from_numpy(port_sketch._blob(seqs, K).copy())
    want_v, want_c = port_sketch.distinct_kmer_counts(
        blob, np.array([len(s) for s in seqs], np.int64), p, (CPU,))
    assert torch.equal(values, want_v) and torch.equal(counts, want_c)
    assert (want_c > 1).any()


def test_membership_brings_back_counts_and_hits_alone(world, monkeypatch):
    """The traced spans and their counters; ``screen-membership`` downloads at
    most 8 bytes a reference, three words a hit and ``s`` values, the query
    side downloads nothing, and no ``np.unique`` or ``np.searchsorted`` runs
    over the reference hashes."""
    sizes = []
    for name in ("unique", "searchsorted"):
        orig = getattr(np, name)
        monkeypatch.setattr(np, name, lambda a, *r, _o=orig, **kw: sizes.append(np.size(a))
                            or _o(a, *r, **kw))
    monkeypatch.setattr(port_trace, "_ENABLED", True)
    port_trace.clear()
    _port(["screen", "-w", str(world["dir"] / "refseq.msh"), str(world["reads"])])
    spans = {s.name: s for s in port_trace.spans() if s.name.startswith("screen-")}
    port_trace.clear()
    assert list(spans) == ["screen-load", "screen-query", "screen-membership", "screen-winner",
                           "screen-lines"]
    load, query, member = spans["screen-load"], spans["screen-query"], spans["screen-membership"]
    refs, ref_hashes = load.counters["references"], load.counters["ref_hashes"]
    assert refs == PARAMS["references"] and ref_hashes == refs * S
    assert load.counters["bytes"] == (world["dir"] / "refseq.msh").stat().st_size
    assert query.counters["records"] == PARAMS["reads"]
    assert query.counters["bases"] == PARAMS["reads"] * PARAMS["read_length"]
    assert query.counters["query_distinct"] == world["query"].keys.numel()
    assert "d2h_bytes" not in query.counters
    hits = member.counters["hits"]
    assert member.counters["ref_hashes"] == ref_hashes
    assert member.counters["query_distinct"] == query.counters["query_distinct"]
    assert 0 < hits == spans["screen-winner"].counters["hits"]
    assert member.counters["d2h_bytes"] == 8 * (refs + 3 * hits + S)
    assert 0 < spans["screen-winner"].counters["winners"] == spans["screen-lines"].counters["lines"]
    assert max(sizes, default=0) < ref_hashes


def test_screen_loads_the_database_as_columns(world, monkeypatch):
    """``screen -w`` of a database of a few thousand references builds no
    ``MshReference`` and no ``Reference`` (both raise here), counts 0
    ``ref_objects`` on ``screen-load``, reads the file in an ``msh-read``
    span inside it, and prints the plain reference's lines."""
    from fpmash_tpu_torch.utils import msh as port_msh

    def built(*args, **kwargs):
        raise AssertionError("a per-reference object was built")

    monkeypatch.setattr(port_msh.MshReference, "__init__", built)
    monkeypatch.setattr(port_sketch.Reference, "__init__", built)
    with pytest.raises(AssertionError, match="per-reference"):
        port_msh.read_msh(str(world["dir"] / "big.msh"))
    monkeypatch.setattr(port_trace, "_ENABLED", True)
    port_trace.clear()
    out = _port(["screen", "-w", str(world["dir"] / "big.msh"), str(world["reads"])])
    spans = port_trace.spans()
    port_trace.clear()
    (load,) = [s for s in spans if s.name == "screen-load"]
    (read,) = [s for s in spans if s.name == "msh-read"]
    assert read.parent == load.id and load.start <= read.start <= read.end <= load.end
    assert load.counters["ref_objects"] == 0
    assert load.counters["references"] == BIG and load.counters["ref_hashes"] == BIG * S
    got = screen_lines.parse(out.encode())
    want = ref_screen.screen(world["big.msh"], world["query"], K, S, winner=True)
    assert len(want) >= 3
    assert [g[:5] for g in got] == [w[:5] for w in want]


# --------------------------------------------------------------------- #
# the record stream built from a file's bytes (ops/seq_stream.py)
# --------------------------------------------------------------------- #

GOLDEN = Path(__file__).parent / "golden"
GOLDENS = ["cfl/DNA3.fasta", "new_data/reads1.fastq", "lyn2vec_basic/example_transcripts_genes.fa"]


def _stream_cases() -> dict:
    """``{name: bytes}``: the goldens, the edge files, and files at the
    places where the native reader stops, skips or trims."""
    rng = np.random.default_rng(31)
    dna = lambda n: np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()  # noqa: E731
    fq = b"".join(b"@r%d c\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                  for i, s in enumerate(dna(int(n)) for n in rng.integers(1, 200, 30)))
    cases = {f"golden:{name}": (GOLDEN / name).read_bytes() for name in GOLDENS}
    cases.update({f"edge:{name}": data for name, data in chip_smoke.edge_files().items()})
    cases.update({
        "fq_no_final_newline": fq[:-1],
        "fq_cut_after_header": fq + b"@tail c\n",
        "fq_cut_in_header": fq + b"@tail",
        "fq_cut_after_sequence": fq + b"@tail\n" + dna(40) + b"\n",
        "fq_cut_in_sequence": fq + b"@tail\n" + dna(40),
        "fq_header_without_at": fq.replace(b"@r7 c", b"r7 c", 1),
        "fq_quality_at_signs": b"@a\nACGTAC\n+\n@@@@@@\n@b\nGGGG\n+\n@@@@\n",
        "fq_leading_blank_lines": b"\n\r\n  \n" + fq,
        "fq_short_records": b"@a\nACG\n+\nIII\n@b\n\n+\n\n@c\nACGTACGTACGTACGTACGTACGT\n+\nx\n",
        "fq_blank_at_record": fq[: len(fq) // 2] + b"\n" + fq[len(fq) // 2 :],
        "fa_leading_blank_lines": b" \n\n\r\n>a x\n" + dna(70) + b"\n" + dna(30) + b"\n>b\n"
                                  + dna(90) + b"\n",
        "fa_empty_record": b">a\n" + dna(50) + b"\n>empty\n>b c\n" + dna(20) + b"\n>\n\n",
        "fa_short_record": b">a\nACGTACGTACGT\n>b\n" + dna(100) + b"\n>c\nAC\n",
        "fa_header_last_line": b">a\n" + dna(60) + b"\n>last",
        "fa_header_last_line_newline": b">a\n" + dna(60) + b"\n>last\n",
        "fa_no_header_first": b"ACGT\n>a\n" + dna(20) + b"\n",
        "fa_carriage_returns": b">a\r\n" + dna(30) + b"\r\r\n\r\n" + dna(5) + b"\r\n>b\r\n\r",
        "fa_long_lines": b"".join(b">g%d\n%s\n" % (i, dna(int(n)))
                                  for i, n in enumerate(rng.integers(1, 20_000, 12))),
        "fa_wrapped": b">w\n" + b"\n".join(dna(60) for _ in range(300)) + b"\n",
        "blank_only": b"\n\r\n \n",
        "empty": b"",
        "one_header": b">only",
        "at_only": b"@",
    })
    return cases


STREAM_CASES = _stream_cases()


def _old_join(paths, k):
    """The stream and lengths as the parent's ``record_stream`` made them: each
    plain file's records from ``parse_seq_file``'s blob and offsets, a ``.gz``
    file's from the Python reader, all joined with ``k - 1`` NUL bytes."""
    from fpmash_tpu_torch.utils.fasta import read_sequences
    from fpmash_tpu_torch.utils.native import parse_seq_file

    seqs = []
    for path in map(str, paths):
        if path.endswith(".gz"):
            seqs += [r.seq.encode("ascii", "replace") for r in read_sequences(path)]
        else:
            _, _, blob, offsets = parse_seq_file(path)
            seqs += [blob[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
    return (b"\0" * (k - 1)).join(seqs), [len(s) for s in seqs]


def _stripped(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data.lstrip(b"\n\r "), np.uint8).copy())


@pytest.mark.parametrize("k", [21, 1])
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_plain_record_stream_equals_the_native_readers_join(tmp_path, name, k):
    """The plain version (``ops/seq_stream.seq_stream_plain``) and
    ``record_stream`` on the CPU give, byte for byte, the parent's join of
    ``parse_seq_file``'s blob and offsets."""
    from fpmash_tpu_torch.ops.seq_stream import seq_stream_plain

    path = tmp_path / "in.fx"
    path.write_bytes(STREAM_CASES[name])
    want, want_len = _old_join([path], k)
    stream, lengths = seq_stream_plain(_stripped(STREAM_CASES[name]), k)
    assert bytes(stream.numpy()) == want and lengths.tolist() == want_len
    stream, lengths = port_sketch.record_stream([str(path)], k, CPU)
    assert bytes(stream.numpy()) == want and lengths.tolist() == want_len


def _mixed_files(d) -> list[str]:
    """FASTA, FASTQ and ``.gz`` files in one list, with an empty file and
    one of no records among them."""
    names = ["fa_empty_record", "fq_cut_after_header", "empty", "fa_wrapped", "fa_no_header_first",
             "golden:new_data/reads1.fastq"]
    paths = []
    for i, name in enumerate(names):
        paths.append(d / f"{i}.fx")
        paths[-1].write_bytes(STREAM_CASES[name])
    with gzip.open(d / "z.fa.gz", "wb") as fh:
        fh.write(STREAM_CASES["fa_long_lines"])
    paths.insert(2, d / "z.fa.gz")
    return [str(p) for p in paths]


@pytest.mark.parametrize("k", [21, 16, 1])
def test_record_stream_of_mixed_files_equals_the_native_readers_join(tmp_path, monkeypatch, k):
    """A list that mixes FASTA, FASTQ and ``.gz`` joins as the parent joined
    it; the span counts the plain files as ``card_files`` and their bytes as
    ``file_bytes``, the ``.gz`` one as ``host_files``, and reads and parses
    each plain file in ``seq-read`` and ``seq-parse`` inside it."""
    paths = _mixed_files(tmp_path)
    want, want_len = _old_join(paths, k)
    monkeypatch.setattr(port_trace, "_ENABLED", True)
    port_trace.clear()
    stream, lengths = port_sketch.record_stream(paths, k, CPU)
    spans = port_trace.spans()
    port_trace.clear()
    assert bytes(stream.numpy()) == want and lengths.tolist() == want_len
    (top,) = [s for s in spans if s.name == "record-stream"]
    plain = [p for p in paths if not p.endswith(".gz")]
    assert top.counters["card_files"] == len(plain) and top.counters["host_files"] == 1
    assert top.counters["file_bytes"] == sum(Path(p).stat().st_size for p in plain)
    for name in ("seq-read", "seq-parse"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == len(plain) and all(s.parent == top.id for s in inner)
    read_bytes = sum(s.counters.get("h2d_bytes", 0) for s in spans if s.name == "seq-read")
    assert read_bytes == sum(len(Path(p).read_bytes().lstrip(b"\n\r ")) for p in plain)


def test_file_to_device_strips_a_long_blank_run(tmp_path):
    """Leading blanks longer than a window of the search are all skipped."""
    from fpmash_tpu_torch.device import file_to_device

    body = b">a\n" + b"ACGT" * 100 + b"\n"
    (tmp_path / "x.fa").write_bytes(b"\n \r" * 5000 + body)
    got = file_to_device(str(tmp_path / "x.fa"), CPU, lstrip=b"\n\r ")
    assert bytes(got.numpy()) == body
    (tmp_path / "y.fa").write_bytes(b"\n" * 9000)
    assert file_to_device(str(tmp_path / "y.fa"), CPU, lstrip=b"\n\r ").numel() == 0


# on the card (no JAX here: ``python -m pytest tests/test_torch_screen_refseq.py -m gpu
# --noconftest``)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_record_stream_kernel_equals_the_plain_version(cuda_device, tmp_path, monkeypatch):
    """``csrc/seq_stream.cu`` against the plain version on every case, at
    k = 21 and 1, from a misaligned view too; ``record_stream`` of the mixed
    list through small pinned chunks; and the benchmark's 1 000 000 x 150
    FASTQ."""
    from bench_port.generators.metagenome import _fastq
    from fpmash_tpu_torch import device as port_device
    from fpmash_tpu_torch.ops import seq_stream as ops_seq

    for name, data in STREAM_CASES.items():
        host = _stripped(data)
        for k in (21, 1):
            want = ops_seq.seq_stream_plain(host, k)
            before = ops_seq.LAUNCHES
            got = ops_seq.seq_stream(host.to(cuda_device), k)
            assert ops_seq.LAUNCHES == before + (7 if host.numel() else 0), name
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), (name, k)
        shifted = torch.cat([torch.zeros(3, dtype=torch.uint8), host]).to(cuda_device)[3:]
        got = ops_seq.seq_stream(shifted, 21)
        assert all(torch.equal(g.cpu(), w)
                   for g, w in zip(got, ops_seq.seq_stream_plain(host, 21))), name
    monkeypatch.setattr(port_device, "UPLOAD_CHUNK", 4096)
    paths = _mixed_files(tmp_path)
    want, want_len = _old_join(paths, 21)
    stream, lengths = port_sketch.record_stream(paths, 21, cuda_device)
    assert stream.device.type == "cuda"
    assert bytes(stream.cpu().numpy()) == want and lengths.tolist() == want_len
    rng = np.random.default_rng(5)
    reads = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (1_000_000, 150))]
    big = torch.from_numpy(np.frombuffer(_fastq(reads, "s0r", "I"), np.uint8).copy())
    got = ops_seq.seq_stream(big.to(cuda_device), 21)
    want = ops_seq.seq_stream_plain(big.to(cuda_device), 21)
    assert got[1].numel() == 1_000_000 and bool((got[1] == 150).all())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
