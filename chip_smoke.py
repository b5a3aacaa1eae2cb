"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the CUDA kernels from ``fpmash_tpu_torch/csrc`` into ``build/``, holds each
kernel against its plain PyTorch version on the card, reproduces the DNA3
golden sketch and the lyn2vec goldens of all ten factorization families
through the CLI, and drives two main paths at the size users run (two
FASTAs of 256 reads x 2 000 bases: ``sketch --direct-fp`` on each, CFL and
then ICFL_COMB, then ``dist -fp`` over the 65 536 pairs).  Every phase
passes or raises; nothing is caught.

The last three lines of standard output are the kernels' JSON record
(launch counts from the main paths, and for the Duval base of
``factor_words`` from the families' CLI runs; exact-match errors; kernel and
plain times), the card's ``name, power.limit`` as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``.  Without a usable card, or outside a
checkout, it exits nonzero and prints no result.  It never imports JAX.
"""

from __future__ import annotations

import contextlib
import json
import struct
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOW = 100
#: each main path's two FASTAs: reads of READ_LEN bases each
N_READS, READ_LEN = 256, 2000


def _time_ms(fn, reps: int) -> float:
    """Warm CUDA-event time of one call of ``fn``, averaged over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(pairs) -> float:
    import numpy as np

    err = 0.0
    for got, want in pairs:
        a = got.cpu().numpy().astype(np.float64)
        b = want.cpu().numpy().astype(np.float64)
        if a.size:
            err = max(err, float(np.abs(a - b).max()))
    return err


def _shift_stream(rng, n_reads: int, read_len: int, alphabet: bytes):
    """Reads as the sketch path ships them (each followed by its first 99
    bases) and the starts of all their cyclic windows."""
    import numpy as np

    lut = np.frombuffer(alphabet, np.uint8)
    reads = lut[rng.integers(0, len(lut), size=(n_reads, read_len))]
    doubled = np.concatenate([reads, reads[:, : WINDOW - 1]], axis=1)
    row = read_len + WINDOW - 1
    starts = (np.arange(n_reads)[:, None] * row + np.arange(read_len)[None, :]).reshape(-1)
    return doubled.reshape(-1), starts.astype(np.int64)


def phase_k1(dev, rng):
    """K1 against its plain version on 65 536 windows (pure ACGT; with N;
    short and empty reads), and 64 of them against the scalar oracle.
    Returns the largest error."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import fused_cuda
    from fpmash_tpu_torch.scalar.lyndon import cfl
    from fpmash_tpu_torch.scalar.murmur3 import murmur3_x64_128

    flat_a, starts_a = _shift_stream(rng, 128, 256, b"ACGT")
    flat_b, starts_b = _shift_stream(rng, 128, 256, b"ACGTACGTACGTACGTN")
    flat = np.concatenate([flat_a, flat_b])
    starts = np.concatenate([starts_a, starts_b + len(flat_a)])
    lengths = np.full(len(starts), WINDOW, np.int32)
    n_ind = len(starts_a) + rng.choice(len(starts_b), 80, replace=False)
    lengths[n_ind[:64]] = rng.integers(1, WINDOW, size=64)  # reads shorter than 100
    lengths[n_ind[64:]] = 0  # empty reads
    args = (
        torch.from_numpy(flat).to(dev),
        torch.from_numpy(starts).to(dev),
        torch.from_numpy(lengths).to(dev),
    )
    got = fused_cuda.fingerprint_hashes(*args, 42)
    want = fused_cuda.fingerprint_hashes_plain(*args, 42)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"K1 {what} differs from the plain version in {bad} windows")
    err = _max_abs_err(zip(got, want))

    h1 = got[0].cpu().numpy().view(np.uint64)
    h2 = got[1].cpu().numpy().view(np.uint64)
    count = got[2].cpu().numpy()
    probe = np.concatenate([rng.choice(len(starts), 48, replace=False), n_ind[:8], n_ind[64:72]])
    for b in probe:
        text = flat[starts[b] : starts[b] + lengths[b]].tobytes().decode("latin-1")
        vec = [len(f) for f in cfl(text)]
        want_h = murmur3_x64_128(b"".join(struct.pack("<Q", v) for v in vec), 42)
        if (int(h1[b]), int(h2[b]), int(count[b])) != (*want_h, len(vec)):
            raise AssertionError(f"K1 window {b} differs from the scalar CFL + MurmurHash3 oracle")

    ms = _time_ms(lambda: fused_cuda.fingerprint_hashes(*args, 42), 50)
    plain_ms = _time_ms(lambda: fused_cuda.fingerprint_hashes_plain(*args, 42), 3)
    print(
        f"K1 fingerprint: {len(starts)} windows equal to the plain version and "
        f"{len(probe)} to the scalar oracle; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    return err


def phase_k2(dev, rng):
    """K2 against its plain version at 256 x 256 pairs of unsorted lists of
    2 000 hashes, s = 1000.  Returns the largest error."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import walk_cuda

    n, width, s = 256, 2000, 1000
    # a shared value pool makes equal elements, so walks advance both sides
    pool = rng.integers(0, 1 << 32, size=20_000, dtype=np.uint64)
    ref = pool[rng.integers(0, len(pool), size=(n, width))]
    qry = pool[rng.integers(0, len(pool), size=(n, width))]
    ref_len = np.full(n, width, np.int32)
    qry_len = np.full(n, width, np.int32)
    ref_len[rng.choice(n, 16, replace=False)] = rng.integers(0, width, size=16)
    qry_len[rng.choice(n, 16, replace=False)] = rng.integers(0, width, size=16)
    args = (
        torch.from_numpy(ref.view(np.int64)).to(dev),
        torch.from_numpy(ref_len).to(dev),
        torch.from_numpy(qry.view(np.int64)).to(dev),
        torch.from_numpy(qry_len).to(dev),
        s,
    )
    got = walk_cuda.pairwise_walk(*args)
    want = walk_cuda.pairwise_walk_plain(*args)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("common", "denom")):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"K2 {what} differs from the plain version in {bad} pairs")
    if int(got[0].sum()) == 0:
        raise AssertionError("K2 test lists share no elements; the check would be vacuous")
    err = _max_abs_err(zip(got, want))
    ms = _time_ms(lambda: walk_cuda.pairwise_walk(*args), 20)
    plain_ms = _time_ms(lambda: walk_cuda.pairwise_walk_plain(*args), 3)
    print(
        f"K2 walk: {n}x{n} pairs of {width}-hash lists, s={s}, equal to the plain "
        f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    return err


def phase_golden(work: Path):
    """``sketch --direct-fp DNA3.fasta`` on the card == the DNA3 golden."""
    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.utils.msh import read_msh

    golden = ROOT / "tests" / "golden" / "cfl"
    rc = main(["sketch", "--direct-fp", str(golden / "DNA3.fasta"), "-o", str(work / "dna3"),
               "--device", "cuda"])
    assert rc == 0, rc
    mine = read_msh(str(work / "dna3.msh"))
    gold = read_msh(str(golden / "DNA3-sketch.msh"))
    if len(mine.references) != len(gold.references):
        raise AssertionError("DNA3: reference count differs from the golden")
    for m, g in zip(mine.references, gold.references):
        if (m.name, m.comment, m.length) != (g.name, g.comment, g.length):
            raise AssertionError(f"DNA3 reference {g.name}: name, comment or length differ")
        if list(map(int, m.hashes32)) != list(map(int, g.hashes32)):
            raise AssertionError(f"DNA3 reference {g.name}: hashes differ from the golden")
    print(f"golden: DNA3 --direct-fp on cuda equals DNA3-sketch.msh "
          f"({len(gold.references)} references)")


def _write_fasta(path: Path, rng, n_reads: int, read_len: int, tag: str) -> list[str]:
    import numpy as np

    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = [lut[rng.integers(0, 4, size=read_len)].tobytes().decode() for _ in range(n_reads)]
    with open(path, "w") as fh:
        for i, seq in enumerate(seqs):
            fh.write(f">{tag}{i} G{tag}{i:05d}\n")
            for p in range(0, read_len, 70):
                fh.write(seq[p : p + 70] + "\n")
    return seqs


#: the kernels each main path must launch (keys of _launches())
MAIN_PATH_KERNELS = {"CFL": ("fingerprint", "walk"),
                     "ICFL_COMB": ("factor_words:icfl", "hash_words", "walk")}


def _reset_counts():
    from fpmash_tpu_torch.models import fingerprint
    from fpmash_tpu_torch.ops import fused_cuda, icfl_cuda, walk_cuda

    fused_cuda.LAUNCHES = 0
    walk_cuda.LAUNCHES = 0
    icfl_cuda.LAUNCHES.update(dict.fromkeys(icfl_cuda.LAUNCHES, 0))
    fingerprint.SCALAR_ROWS.update(dict.fromkeys(fingerprint.SCALAR_ROWS, 0))


def _launches() -> dict:
    from fpmash_tpu_torch.ops import fused_cuda, icfl_cuda, walk_cuda

    out = {"fingerprint": fused_cuda.LAUNCHES, "walk": walk_cuda.LAUNCHES}
    for key, n in icfl_cuda.LAUNCHES.items():
        out["hash_words" if key == "hash_words" else f"factor_words:{key}"] = n
    return out


def phase_main_path(dev, rng, work: Path, family: str):
    """The fp workflow at 256 reads x 2 000 bases per FASTA through the CLI:
    ``sketch --direct-fp --factorization family`` on both, ``dist -fp``."""
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models import fingerprint
    from fpmash_tpu_torch.models.distance import compare_sketches
    from fpmash_tpu_torch.models.sketch import Sketch

    n_reads, read_len = N_READS, READ_LEN
    work = work / family
    work.mkdir(parents=True, exist_ok=True)
    seqs_a = _write_fasta(work / "a.fasta", rng, n_reads, read_len, "a")
    _write_fasta(work / "b.fasta", rng, n_reads, read_len, "b")
    bases = n_reads * read_len

    _reset_counts()
    walls = {}
    for tag in ("a", "b"):
        t0 = time.perf_counter()
        rc = main(["sketch", "--direct-fp", str(work / f"{tag}.fasta"), "-o", str(work / tag),
                   "--factorization", family, "--device", "cuda"])
        torch.cuda.synchronize()
        walls[f"sketch_{tag}"] = time.perf_counter() - t0
        assert rc == 0, rc
    dist_out = work / "dist.txt"
    t0 = time.perf_counter()
    with open(dist_out, "w") as fh, contextlib.redirect_stdout(fh):
        rc = main(["dist", "-fp", str(work / "a.msh"), str(work / "b.msh"), "--device", "cuda"])
    torch.cuda.synchronize()
    walls["dist"] = time.perf_counter() - t0
    assert rc == 0, rc
    launches = _launches()
    scalar_rows = dict(fingerprint.SCALAR_ROWS)
    missing = [k for k in MAIN_PATH_KERNELS[family] if launches[k] < 1]
    if missing:
        raise AssertionError(f"the {family} main path did not launch {missing}: {launches}")
    if scalar_rows["ok_false"] or scalar_rows["wide"]:
        raise AssertionError(f"the {family} main path sent rows to the scalar model: {scalar_rows}")

    # dist: one line per pair, finite values, and a sample against the literal walk
    lines = dist_out.read_text().splitlines()
    if len(lines) != n_reads * n_reads:
        raise AssertionError(f"dist printed {len(lines)} lines, not {n_reads * n_reads}")
    qry = Sketch()
    qry.load_msh(str(work / "b.msh"))
    ref = Sketch()
    ref.load_msh(str(work / "a.msh"))
    p = ref.params
    for li in rng.choice(len(lines), min(64, len(lines)), replace=False):
        rname, qname, d, pv, frac = lines[li].split("\t")
        if not (0.0 <= float(d) <= 1.0 and 0.0 <= float(pv) <= 1.0):
            raise AssertionError(f"dist line {li} out of range: {lines[li]}")
        qi, ri = divmod(int(li), n_reads)
        r, q = ref.references[ri], qry.references[qi]
        res = compare_sketches(r.hashes, q.hashes, r.length, q.length, p.sketch_size,
                               p.kmer_size, p.kmer_space)
        if (rname, qname, frac) != (r.name, q.name, f"{res.numer}/{res.denom}"):
            raise AssertionError(f"dist line {li} differs from the literal walk: {lines[li]}")

    for tag in ("a", "b"):
        w = walls[f"sketch_{tag}"]
        print(f"main path {family}: sketch --direct-fp {tag}.fasta ({n_reads} reads x "
              f"{read_len} bases, {bases} windows): {w:.3f} s wall, {bases / w:.1f} bases/s")
    pairs = n_reads * n_reads
    print(f"main path {family}: dist -fp a.msh b.msh ({pairs} pairs): {walls['dist']:.3f} s "
          f"wall, {pairs / walls['dist']:.1f} pairs/s; e2e "
          f"{2 * bases / sum(walls.values()):.1f} bases/s; launches {launches}; "
          f"rows sent to the scalar model {scalar_rows}")
    return launches, seqs_a


def phase_main_shapes(dev, work: Path, seqs_a):
    """Both kernels against their plain versions at the shapes the main path
    gave them: a.fasta's 512 000 shift windows, and the 256 x 256 sketches
    as ``dist`` loaded them.  Every hash of a.msh must equal the plain
    version's.  Returns each kernel's error and times at these shapes."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.models.sketch import Sketch
    from fpmash_tpu_torch.ops import fused_cuda, walk_cuda
    from fpmash_tpu_torch.ops.walk import pad_lists

    k1_args = _main_stream(dev, seqs_a)
    starts = k1_args[1]
    got = fused_cuda.fingerprint_hashes(*k1_args, 42)
    want = fused_cuda.fingerprint_hashes_plain(*k1_args, 42)
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 {what} differs from the plain version on a.fasta")
    sketch_a = Sketch()
    sketch_a.load_msh(str(work / "CFL" / "a.msh"), truncate=False)
    low32 = want[0].cpu().numpy().view(np.uint64) & np.uint64(0xFFFFFFFF)
    if not np.array_equal(np.concatenate([r.hashes for r in sketch_a.references]), low32):
        raise AssertionError("a.msh hashes differ from the plain version's")
    k1 = {
        "max_abs_err": _max_abs_err(zip(got, want)),
        "ms": _time_ms(lambda: fused_cuda.fingerprint_hashes(*k1_args, 42), 50),
        "plain_ms": _time_ms(lambda: fused_cuda.fingerprint_hashes_plain(*k1_args, 42), 3),
    }

    ref, qry = Sketch(), Sketch()
    ref.load_msh(str(work / "CFL" / "a.msh"))
    qry.load_msh(str(work / "CFL" / "b.msh"))
    s = min(ref.params.sketch_size, qry.params.sketch_size)
    k2_args = (*pad_lists([r.hashes for r in ref.references], dev),
               *pad_lists([q.hashes for q in qry.references], dev), s)
    got = walk_cuda.pairwise_walk(*k2_args)
    want = walk_cuda.pairwise_walk_plain(*k2_args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("K2 differs from the plain version on the dist sketches")
    k2 = {
        "max_abs_err": _max_abs_err(zip(got, want)),
        "ms": _time_ms(lambda: walk_cuda.pairwise_walk(*k2_args), 50),
        "plain_ms": _time_ms(lambda: walk_cuda.pairwise_walk_plain(*k2_args), 3),
    }
    print(f"main-path shapes: K1 at {len(starts)} windows kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms; K2 at {len(ref)}x{len(qry)} sketches of "
          f"{k2_args[0].shape[1]} kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms; "
          "both equal to the plain versions")
    return k1, k2


FAMILIES = ("CFL", "ICFL", "CFL_ICFL-10", "CFL_ICFL-20", "CFL_ICFL-30", "CFL_COMB",
            "ICFL_COMB", "CFL_ICFL_COMB-10", "CFL_ICFL_COMB-20", "CFL_ICFL_COMB-30")


def _main_stream(dev, seqs):
    """The shift-window stream of ``seqs`` exactly as models/sketch.py ships it."""
    import torch

    from fpmash_tpu_torch.models.fingerprint import window_stream

    flat, starts, lengths, _ = window_stream(seqs, shift=True)
    return tuple(torch.from_numpy(a).to(dev) for a in (flat, starts, lengths))


def _mixed_windows(rng):
    """About 65 536 shift windows: pure ACGT, N-bearing, homopolymer and
    periodic reads (periodic rows force many ICFL levels), with 64 windows
    cut shorter than 100 and 16 emptied."""
    import numpy as np

    from fpmash_tpu_torch.models.fingerprint import window_stream

    def reads(alphabet, n):
        lut = np.frombuffer(alphabet, np.uint8)
        return [lut[rng.integers(0, len(lut), size=256)].tobytes().decode() for _ in range(n)]

    texts = reads(b"ACGT", 128) + reads(b"ACGTACGTACGTACGTN", 124)
    texts += ["ACACGTGT" * 32, "A" * 256, "AC" * 128, "T" * 255 + "A"]
    flat, starts, lengths, _ = window_stream(texts, shift=True)
    cut = rng.choice(len(starts), 80, replace=False)
    lengths[cut[:64]] = rng.integers(1, WINDOW, size=64)
    lengths[cut[64:]] = 0
    return flat, starts, lengths, cut


def _wide_rows(rng):
    """64 whole reads of 300-1 000 characters, as ``--shift no_shift`` or
    ``--type generalized`` send them."""
    import numpy as np

    from fpmash_tpu_torch.models.fingerprint import window_stream

    texts = []
    for k in range(64):
        n = int(rng.integers(300, 1001))
        if k % 8 == 7:
            texts.append(("ACACGTGT" * 125)[:n])
        else:
            lut = np.frombuffer(b"ACGTACGTN" if k % 2 else b"ACGT", np.uint8)
            texts.append(lut[rng.integers(0, len(lut), size=n)].tobytes().decode())
    flat, starts, lengths, _ = window_stream(texts, shift=False)
    return flat, starts, lengths


def _check_family_rows(dev, family, flat, starts, lengths, probe):
    """factor_words and hash_words against their plain versions on one batch,
    and the ``probe`` rows against the scalar model.  Returns the errors."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.models.fingerprint import lengths_from_words, scalar_lengths
    from fpmash_tpu_torch.ops import icfl_cuda
    from fpmash_tpu_torch.scalar.murmur3 import hash_u64_vector

    args = [torch.from_numpy(a).to(dev) for a in (flat, starts, lengths)]
    words, ok = icfl_cuda.factor_words(*args, family)
    want_words, want_ok = icfl_cuda.factor_words_plain(*args, family)
    torch.cuda.synchronize()
    if not (torch.equal(words, want_words) and torch.equal(ok, want_ok)):
        bad = int((words != want_words).any(dim=1).sum())
        raise AssertionError(f"{family}: factor_words differs from the plain version in {bad} rows")
    if not bool(ok.all()):
        raise AssertionError(f"{family}: factor_words reported {int((~ok).sum())} rows not ok")
    got = icfl_cuda.hash_words(words, args[2], 42)
    want = icfl_cuda.hash_words_plain(words, args[2], 42)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            raise AssertionError(f"{family}: hash_words {what} differs from the plain version")
    lens = lengths_from_words(words.cpu().numpy()[probe], lengths[probe])
    h1 = got[0].cpu().numpy().view(np.uint64)
    for b, ls in zip(probe, lens):
        text = flat[starts[b] : starts[b] + lengths[b]].tobytes().decode("latin-1")
        vec = scalar_lengths(text, family)
        if ls.tolist() != vec or int(h1[b]) != hash_u64_vector(vec, 42, use64=True):
            raise AssertionError(f"{family}: window {b} differs from the scalar model")
    return _max_abs_err([(words, want_words), (ok, want_ok)]), _max_abs_err(zip(got, want))


def phase_factor_kernels(dev, rng):
    """K3/K14 (factor_words) and K4 (hash_words) against their plain
    versions for all ten families on the mixed windows and on a batch of
    300-1 000-character rows, 64 windows of each against the scalar model,
    and K4 on arbitrary words.  Returns the largest errors by kernel."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import icfl_cuda
    from fpmash_tpu_torch.ops.factorize import FAMILY_PLANS

    flat, starts, lengths, cut = _mixed_windows(rng)
    probe = np.concatenate([rng.choice(len(starts), 48, replace=False), cut[:8], cut[64:72]])
    wide = _wide_rows(rng)
    errs = {"icfl": 0.0, "cfl": 0.0, "hash_words": 0.0}
    t0 = time.perf_counter()
    for family in FAMILIES:
        base = FAMILY_PLANS[family][0]
        for batch, rows in (((flat, starts, lengths), probe), (wide, np.arange(0, 64, 8))):
            e_words, e_hash = _check_family_rows(dev, family, *batch, rows)
            for key in ({"cfl": ["cfl"], "icfl": ["icfl"]}.get(base, ["cfl", "icfl"])):
                errs[key] = max(errs[key], e_words)
            errs["hash_words"] = max(errs["hash_words"], e_hash)

    # K4 on arbitrary bits, including bits past n and rows that are not valid
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(4096, 4), dtype=np.int64)
                             .astype(np.int32)).to(dev)
    n = rng.integers(0, 129, size=4096).astype(np.int32)
    n[:3] = [-1, 129, 0]
    n = torch.from_numpy(n).to(dev)
    got = icfl_cuda.hash_words(words, n, 7)
    want = icfl_cuda.hash_words_plain(words, n, 7)
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            raise AssertionError(f"hash_words {what} differs from the plain version on random words")
    errs["hash_words"] = max(errs["hash_words"], _max_abs_err(zip(got, want)))
    print(f"K3/K14/K4: all ten families on {len(starts)} mixed windows and 64 rows of "
          f"300-1000 equal to the plain versions, {len(probe)} + 8 rows each to the scalar "
          f"model; K4 on 4096 random word rows too ({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_families_golden(work: Path):
    """All ten families on the lyn2vec golden FASTA through the CLI on cuda:
    ``fingerprint`` equals ``fingerprint_F.txt[.gz]`` (and the ``fact_``
    file where there is one), and ``sketch --direct-fp --factorization F``
    equals the port's ``sketch -fp`` of the golden, hash for hash.  The
    uncompressed goldens cover a prefix of the records (``--rev_comb
    false``); the gzipped ones all of them (``--rev_comb true``).  Returns
    the launches of this phase."""
    import gzip

    import numpy as np

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.utils.msh import read_msh

    golden = ROOT / "tests" / "golden" / "lyn2vec_basic"
    fasta = golden / "example_transcripts_genes.fa"

    def golden_text(name):
        for path, opener in ((golden / name, open), (golden / f"{name}.gz", gzip.open)):
            if path.exists():
                with opener(path, "rt") as fh:
                    return fh.read(), path.suffix == ".gz"
        return None, None

    def hashes(path):
        return np.concatenate([r.hashes32 for r in read_msh(str(path)).references])

    _reset_counts()
    for family in FAMILIES:
        out = work / "families" / family
        out.mkdir(parents=True, exist_ok=True)
        gold, whole = golden_text(f"fingerprint_{family}.txt")
        rev = "true" if whole else "false"
        rc = main(["fingerprint", "--path", str(out), "--fasta", str(fasta),
                   "--type_factorization", family, "--rev_comb", rev, "--device", "cuda"])
        assert rc == 0, rc
        mine = (out / f"fingerprint_{family}.txt").read_text()
        if not (mine == gold or (not whole and mine.startswith(gold))):
            raise AssertionError(f"{family}: fingerprint differs from the golden")
        fact, _ = golden_text(f"fact_fingerprint_{family}.txt")
        if fact is not None:
            mine_fact = (out / f"fact_fingerprint_{family}.txt").read_text().splitlines()
            gold_fact = fact.splitlines()
            if mine_fact[: len(gold_fact)] != gold_fact or (whole and mine_fact != gold_fact):
                raise AssertionError(f"{family}: fact_fingerprint differs from the golden")
        (out / "golden.txt").write_text(gold)
        for args in (["--direct-fp", str(fasta), "--factorization", family, "--rev-comb", rev,
                      "-o", str(out / "direct")],
                     ["-fp", str(out / "golden.txt"), "-o", str(out / "txt")]):
            assert main(["sketch", *args, "--device", "cuda"]) == 0
        direct, txt = hashes(out / "direct.msh"), hashes(out / "txt.msh")
        if not np.array_equal(direct if whole else direct[: len(txt)], txt):
            raise AssertionError(f"{family}: sketch --direct-fp differs from sketch -fp of the golden")
    launches = _launches()
    if launches["factor_words:cfl"] + launches["factor_words:cfl_icfl"] < 1:
        raise AssertionError(f"the families' CLI runs did not launch the Duval kernel: {launches}")
    print(f"golden: all ten families on cuda equal the lyn2vec goldens (fingerprint, fact "
          f"files, --direct-fp vs -fp); launches {launches}")
    return launches


def phase_icfl_main_shapes(dev, work: Path, seqs_a):
    """K3, K4 and K14 against their plain versions at the ICFL_COMB main
    path's shape (a.fasta's 512 000 shift windows); every hash of its a.msh
    must equal the plain version's.  K3 is timed on ICFL_COMB (the main
    path's launch) and K14 on CFL_COMB, the Duval base of the same kernel."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.models.sketch import Sketch
    from fpmash_tpu_torch.ops import icfl_cuda

    args = _main_stream(dev, seqs_a)
    out = {}
    for name, family in (("k3", "ICFL_COMB"), ("k14", "CFL_COMB")):
        got = icfl_cuda.factor_words(*args, family)
        want = icfl_cuda.factor_words_plain(*args, family)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"factor_words {family} differs from the plain version on a.fasta")
        if not bool(got[1].all()):
            raise AssertionError(f"factor_words {family}: {int((~got[1]).sum())} rows not ok")
        out[name] = {
            "max_abs_err": _max_abs_err(zip(got, want)),
            "ms": _time_ms(lambda f=family: icfl_cuda.factor_words(*args, f), 20),
            "plain_ms": _time_ms(lambda f=family: icfl_cuda.factor_words_plain(*args, f), 1),
        }
        if family == "ICFL_COMB":
            words = got[0]

    got = icfl_cuda.hash_words(words, args[2], 42)
    want = icfl_cuda.hash_words_plain(words, args[2], 42)
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            raise AssertionError(f"K4 {what} differs from the plain version on a.fasta")
    sketch_a = Sketch()
    sketch_a.load_msh(str(work / "ICFL_COMB" / "a.msh"), truncate=False)
    low32 = want[0].cpu().numpy().view(np.uint64) & np.uint64(0xFFFFFFFF)
    if not np.array_equal(np.concatenate([r.hashes for r in sketch_a.references]), low32):
        raise AssertionError("ICFL_COMB a.msh hashes differ from the plain version's")
    out["k4"] = {
        "max_abs_err": _max_abs_err(zip(got, want)),
        "ms": _time_ms(lambda: icfl_cuda.hash_words(words, args[2], 42), 50),
        "plain_ms": _time_ms(lambda: icfl_cuda.hash_words_plain(words, args[2], 42), 3),
    }
    for family in ("ICFL", "CFL"):  # one pass of each base, for reference
        ms = _time_ms(lambda f=family: icfl_cuda.factor_words(*args, f), 20)
        print(f"main-path shapes: factor_words {family} at {len(args[1])} windows {ms:.4f} ms")
    print(f"main-path shapes: at {len(args[1])} windows K3 (factor_words ICFL_COMB) kernel "
          f"{out['k3']['ms']:.4f} ms, plain {out['k3']['plain_ms']:.4f} ms; K14 (factor_words "
          f"CFL_COMB) kernel {out['k14']['ms']:.4f} ms, plain {out['k14']['plain_ms']:.4f} ms; "
          f"K4 (hash_words) kernel {out['k4']['ms']:.4f} ms, plain {out['k4']['plain_ms']:.4f} ms;"
          " all equal to the plain versions")
    return out["k3"], out["k4"], out["k14"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "fpmash_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no fpmash_tpu_torch package beside {__file__}: run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from fpmash_tpu_torch.device import gpu_report
    from fpmash_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    smi = gpu_report()
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} from csrc/*.cu in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(2026)
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    err1 = phase_k1(dev, rng)
    err2 = phase_k2(dev, rng)
    errs = phase_factor_kernels(dev, rng)
    phase_golden(work)
    family_launches = phase_families_golden(work)
    launches, seqs_a = phase_main_path(dev, rng, work, "CFL")
    k1, k2 = phase_main_shapes(dev, work, seqs_a)
    icfl_launches, seqs_i = phase_main_path(dev, rng, work, "ICFL_COMB")
    k3, k4, k14 = phase_icfl_main_shapes(dev, work, seqs_i)
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    k2["max_abs_err"] = max(k2["max_abs_err"], err2)
    k3["max_abs_err"] = max(k3["max_abs_err"], errs["icfl"])
    k4["max_abs_err"] = max(k4["max_abs_err"], errs["hash_words"])
    k14["max_abs_err"] = max(k14["max_abs_err"], errs["cfl"])

    src = "fpmash_tpu_torch/csrc/"
    kernels = [
        {"name": "fingerprint", "route": "cuda", "source": src + "fingerprint.cu",
         "replaces": "fpmash_tpu/ops/fused_pallas.py:339", "launches": launches["fingerprint"],
         **k1},
        {"name": "walk", "route": "cuda", "source": src + "walk.cu",
         "replaces": "fpmash_tpu/ops/walk_pallas.py:41", "launches": launches["walk"], **k2},
        {"name": "factor_words_icfl", "route": "cuda", "source": src + "factor_words.cu",
         "replaces": "fpmash_tpu/ops/icfl_pallas.py:88",
         "launches": icfl_launches["factor_words:icfl"], **k3},
        {"name": "hash_words", "route": "cuda", "source": src + "hash_words.cu",
         "replaces": "fpmash_tpu/ops/icfl_pallas.py:291", "launches": icfl_launches["hash_words"],
         **k4},
        {"name": "factor_words_cfl", "route": "cuda", "source": src + "factor_words.cu",
         "replaces": "fpmash_tpu/ops/lyndon_pallas.py:30",
         "launches": family_launches["factor_words:cfl"]
         + family_launches["factor_words:cfl_icfl"], **k14},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
