"""The plain reference reproduces Mash's and fp-mash's golden files, and its
batched code agrees with its own scalar walks."""

import gzip
import random

import pytest
import torch

from bench_port.reference import fingerprint, kmers, lyndon, msh, murmur3, seqio
from bench_port.tests.tiny import ROOT

GOLDEN = ROOT / "tests" / "golden"


def test_murmur3_known_value():
    # MurmurHash3_x64_128("hello", seed 0): h1 = 0xcbd8a7b341bd9b02
    assert murmur3.murmur3_bytes(b"hello", 0) == 0xCBD8A7B341BD9B02


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fp_sketch_reproduces_dna_golden(n):
    records = seqio.read_records(str(GOLDEN / "cfl" / f"DNA{n}.fasta"))
    want = msh.read_msh((GOLDEN / "cfl" / f"DNA{n}-sketch.msh").read_bytes())
    got = fingerprint.fp_sketch(records, "CFL", "cpu")
    assert (want.kmer, want.alphabet, want.seed, want.hash_bits) == (1, "0123456789", 42, 32)
    assert [(e.name, e.comment, e.length, e.hashes) for e in got] == [
        (r.name, r.comment, r.length, r.hashes) for r in want.refs]


def test_reads_sketch_reproduces_reads_golden():
    # sketch -r -I reads reads1.fastq reads2.fastq: k 21, s 1000, counts
    want = msh.read_msh((GOLDEN / "new_data" / "reads.msh").read_bytes())
    records = [r for f in ("reads1.fastq", "reads2.fastq")
               for r in seqio.read_records(str(GOLDEN / "new_data" / f))]
    rows = torch.zeros(len(records), max(len(s) for _, s in records), dtype=torch.uint8)
    for i, (_, s) in enumerate(records):
        rows[i, : len(s)] = torch.tensor(list(s.encode()), dtype=torch.uint8)
    values, counts = kmers.bottom_s(*kmers.sketch_rows(rows, 21, 42), 1000)
    (ref,) = want.refs
    assert values == ref.hashes and counts == ref.counts
    assert kmers.set_size_estimate(values, 1000, 64) == ref.length


def _scalar_sketch(seq: str, k: int, s: int, seed: int, min_copies: int = 1):
    """A scalar walk: every window of k letters, its canonical form, its hash."""
    comp = str.maketrans("ACGT", "TGCA")
    seen = {}
    for p in range(len(seq) - k + 1):
        w = seq[p : p + k].upper()
        if set(w) - set("ACGT"):
            continue
        rc = w.translate(comp)[::-1]
        h = murmur3.murmur3_bytes(min(w, rc).encode(), seed)
        seen[h] = seen.get(h, 0) + 1
    keep = sorted(h for h, c in seen.items() if c >= min_copies)[:s]
    return keep, [seen[h] for h in keep]


@pytest.mark.parametrize("k,s", [(21, 50), (16, 30), (31, 40)])
def test_kmer_sketch_agrees_with_scalar_walk(k, s):
    rng = random.Random(k)
    seq = "".join(rng.choice("ACGTacgtN" if i % 97 == 0 else "ACGT") for i in range(3000))
    want, _ = _scalar_sketch(seq, k, s, 42)
    got, _ = kmers.genome_sketch(torch.tensor(list(seq.encode()), dtype=torch.uint8), k, s, 42,
                                 block=700)
    assert got == want


def test_read_set_counts_agree_with_scalar_walk():
    rng = random.Random(5)
    genome = "".join(rng.choice("ACGT") for _ in range(400))
    reads = [genome[p : p + 60] for p in (rng.randrange(340) for _ in range(80))]
    rows = torch.tensor([list(r.encode()) for r in reads], dtype=torch.uint8)
    got = kmers.bottom_s(*kmers.sketch_rows(rows, 21, 42, block=500), 100, 2)
    seen = {}
    for r in reads:
        hs, cs = _scalar_sketch(r, 21, 10**9, 42)
        for h, c in zip(hs, cs):
            seen[h] = seen.get(h, 0) + c
    keep = sorted(h for h, c in seen.items() if c >= 2)[:100]
    assert got == (keep, [seen[h] for h in keep])


@pytest.mark.parametrize("family", ["CFL", "ICFL", "CFL_COMB", "ICFL_COMB"])
def test_batched_factorizations_agree_with_scalar_walks(family):
    rng = random.Random(family)
    words = ["".join(rng.choice("ACGT") for _ in range(rng.choice([1, 2, 3, 17, 99, 100])))
             for _ in range(600)]
    words += ["A" * 100, "T" * 100, "AC" * 50, "CA" * 50, "ACGT" * 25, "TTTA" * 25]
    buf = torch.zeros(len(words), 100, dtype=torch.uint8)
    for i, w in enumerate(words):
        buf[i, : len(w)] = torch.tensor(list(w.encode()), dtype=torch.uint8)
    n = torch.tensor([len(w) for w in words])
    vecs, counts = fingerprint.lengths_from_marks(lyndon.factor_marks(family, buf, n), n)
    for i, w in enumerate(words):
        assert vecs[i, : counts[i]].tolist() == lyndon.SCALAR[family](w), w


@pytest.mark.parametrize("family", ["CFL", "ICFL_COMB"])
def test_factorizations_reproduce_lyn2vec_golden(family):
    """``fingerprint_<family>.txt`` holds a prefix of the golden FASTA's
    windows with ``--rev_comb false``: one line a cyclic window of 100."""
    path = GOLDEN / "lyn2vec_basic" / f"fingerprint_{family}.txt"
    lines = (gzip.open(path, "rt") if path.suffix == ".gz" else open(path)).read().splitlines()
    records = seqio.read_records(str(GOLDEN / "lyn2vec_basic" / "example_transcripts_genes.fa"))
    wins = []
    for _, seq in records:
        seq = seq.upper()
        wins += [(seq + seq[:99])[i : i + 100] for i in range(len(seq))] if len(seq) >= 100 \
            else [seq]
        if len(wins) >= 3000:
            break
    wins = wins[:3000]
    buf = torch.zeros(len(wins), 100, dtype=torch.uint8)
    for i, w in enumerate(wins):
        buf[i, : len(w)] = torch.tensor(list(w.encode()), dtype=torch.uint8)
    n = torch.tensor([len(w) for w in wins])
    vecs, counts = fingerprint.lengths_from_marks(lyndon.factor_marks(family, buf, n), n)
    got = [vecs[i, : counts[i]].tolist() for i in range(len(wins))]
    want = [[int(x) for x in line.split()[1:]] for line in lines[: len(wins)]]
    assert got == want


class _Sketches:
    """A stand-in for ``harness/check.Reference``: entries by index, a header."""

    def __init__(self, entries, header):
        self._entries, self.header, self.device = entries, header, "cpu"

    def entries(self, idx):
        return self._entries[idx]


def _wants(m, name=None):
    from bench_port.harness.check import Want

    return [Want(name or r.name, r.comment, r.length, r.hashes, None) for r in m.refs]


def test_dist_lines_reproduce_mash_golden():
    """Mash's own ``dist`` of three genomes against a read set, p-values down
    to 1e-214 (``mash_ref/genomes.dist``)."""
    from bench_port.checks import dist_lines

    genomes = [_wants(msh.read_msh((GOLDEN / "mash_ref" / f"genome{n}.fna.msh").read_bytes()),
                      f"genome{n}.fna") for n in (1, 2, 3)]
    reads = msh.read_msh((GOLDEN / "new_data" / "reads.msh").read_bytes())
    sketches = _Sketches(genomes + [_wants(reads)],
                         {"kmer": reads.kmer, "sketch_size": reads.sketch_size,
                          "alphabet": reads.alphabet})
    want = dist_lines.expected(sketches, ((0, 1, 2), (3,)))
    golden = dist_lines.parse((GOLDEN / "mash_ref" / "genomes.dist").read_bytes())
    assert dist_lines.compare(golden, want, sketches) == {"wrong_pairs": 0}
    assert dist_lines.compare(dist_lines.render(want, sketches), want, sketches) == {
        "wrong_pairs": 0}
    off = [golden[0][:4] + (golden[0][4] + 1, golden[0][5])] + golden[1:]
    assert dist_lines.compare(off, want, sketches) == {"wrong_pairs": 1}


def _scalar_walk(a, b, s):
    i = j = common = denom = 0
    while denom < s and i < len(a) and j < len(b):
        if a[i] < b[j]:
            i += 1
        elif b[j] < a[i]:
            j += 1
        else:
            i, j, common = i + 1, j + 1, common + 1
        denom += 1
    if denom < s:
        denom = min(s, denom + max(0, len(a) - i) + max(0, len(b) - j))
    return common, denom


@pytest.mark.parametrize("seed", range(4))
def test_dist_walk_matches_scalar_walk(seed):
    """Unsorted lists with repeats and hashes past 2^63, as fingerprint
    sketches hold them, at caps below and above the lists' lengths."""
    from bench_port.checks import dist_lines
    from bench_port.harness.check import Want

    rng = random.Random(seed)
    pool = [rng.randrange(1 << 64) for _ in range(12)]
    lists = [[rng.choice(pool) for _ in range(rng.randrange(0, 40))] for _ in range(9)]
    wants = [Want(f"r{n}", "", 1, h, None) for n, h in enumerate(lists)]
    for s in (1, 7, 25, 1000):
        A, la = dist_lines._lists(wants[:4], s)
        B, lb = dist_lines._lists(wants[4:], s)
        common, denom = dist_lines.walk(A, la, B, lb, s)
        for r in range(4):
            for q in range(5):
                got = (int(common[r, q]), int(denom[r, q]))
                assert got == _scalar_walk(lists[r][:s], lists[4 + q][:s], s)


def test_binom_tail_matches_exact_sum():
    from fractions import Fraction
    from math import comb

    from bench_port.checks import dist_lines

    cases = [(k, n, p) for n in (1, 5, 40, 200) for k in (-1, 0, 3, n - 1, n)
             for p in (0.0, 1e-9, 0.3, 0.995, 1.0)]
    k = torch.tensor([c[0] for c in cases])
    n = torch.tensor([c[1] for c in cases])
    p = torch.tensor([c[2] for c in cases], dtype=torch.float64)
    got = dist_lines.binom_tail(k, n, p).tolist()
    for (kk, nn, pp), g in zip(cases, got):
        if nn <= 0 or pp <= 0:
            want = 0.0
        elif pp >= 1:
            want = 1.0 if kk < nn else 0.0
        else:
            f = Fraction(pp)
            want = float(sum(comb(nn, i) * f**i * (1 - f) ** (nn - i)
                             for i in range(max(kk + 1, 0), nn + 1)))
        assert g == pytest.approx(want, rel=1e-10, abs=1e-300), (kk, nn, pp)
