"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the CUDA kernels from ``fpmash_tpu_torch/csrc`` into ``build/``, holds each
kernel against its plain PyTorch version on the card, reproduces the DNA3
golden sketch through the CLI, and drives the fingerprint main path at the
size users run (two FASTAs of 256 reads x 2 000 bases: ``sketch
--direct-fp`` on each, then ``dist -fp`` over the 65 536 pairs).  Every
phase passes or raises; nothing is caught.

The last three lines of standard output are the kernels' JSON record
(launch counts from the main path, exact-match errors, kernel and plain
times), the card's ``name, power.limit`` as ``nvidia-smi`` gives them, and
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


def phase_main_path(dev, rng, work: Path):
    """The fp workflow at 256 reads x 2 000 bases per FASTA through the CLI."""
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models.distance import compare_sketches
    from fpmash_tpu_torch.models.sketch import Sketch
    from fpmash_tpu_torch.ops import fused_cuda, walk_cuda

    n_reads, read_len = 256, 2000
    seqs_a = _write_fasta(work / "a.fasta", rng, n_reads, read_len, "a")
    _write_fasta(work / "b.fasta", rng, n_reads, read_len, "b")
    bases = n_reads * read_len

    fused_cuda.LAUNCHES = 0
    walk_cuda.LAUNCHES = 0
    walls = {}
    for tag in ("a", "b"):
        t0 = time.perf_counter()
        rc = main(["sketch", "--direct-fp", str(work / f"{tag}.fasta"), "-o", str(work / tag),
                   "--device", "cuda"])
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
    launches = {"fingerprint": fused_cuda.LAUNCHES, "walk": walk_cuda.LAUNCHES}
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")

    # dist: one line per pair, finite values, and a sample against the literal walk
    lines = dist_out.read_text().splitlines()
    if len(lines) != n_reads * n_reads:
        raise AssertionError(f"dist printed {len(lines)} lines, not {n_reads * n_reads}")
    qry = Sketch()
    qry.load_msh(str(work / "b.msh"))
    ref = Sketch()
    ref.load_msh(str(work / "a.msh"))
    p = ref.params
    for li in rng.choice(len(lines), 64, replace=False):
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
        print(f"main path: sketch --direct-fp {tag}.fasta ({n_reads} reads x {read_len} bases, "
              f"{bases} windows): {w:.3f} s wall, {bases / w:.1f} bases/s")
    pairs = n_reads * n_reads
    print(f"main path: dist -fp a.msh b.msh ({pairs} pairs): {walls['dist']:.3f} s wall, "
          f"{pairs / walls['dist']:.1f} pairs/s; e2e {2 * bases / sum(walls.values()):.1f} "
          f"bases/s; launches {launches}")
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

    # the stream exactly as models/sketch.py ships it
    chunks = [(s + s[: WINDOW - 1]).encode() for s in seqs_a]
    offsets = np.cumsum([0] + [len(c) for c in chunks[:-1]])
    starts = np.concatenate([o + np.arange(len(s)) for o, s in zip(offsets, seqs_a)])
    k1_args = (
        torch.frombuffer(bytearray(b"".join(chunks)), dtype=torch.uint8).to(dev),
        torch.from_numpy(starts.astype(np.int64)).to(dev),
        torch.full((len(starts),), WINDOW, dtype=torch.int32, device=dev),
    )
    got = fused_cuda.fingerprint_hashes(*k1_args, 42)
    want = fused_cuda.fingerprint_hashes_plain(*k1_args, 42)
    for g, w, what in zip(got, want, ("h1", "h2", "count")):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 {what} differs from the plain version on a.fasta")
    sketch_a = Sketch()
    sketch_a.load_msh(str(work / "a.msh"), truncate=False)
    low32 = want[0].cpu().numpy().view(np.uint64) & np.uint64(0xFFFFFFFF)
    if not np.array_equal(np.concatenate([r.hashes for r in sketch_a.references]), low32):
        raise AssertionError("a.msh hashes differ from the plain version's")
    k1 = {
        "max_abs_err": _max_abs_err(zip(got, want)),
        "ms": _time_ms(lambda: fused_cuda.fingerprint_hashes(*k1_args, 42), 50),
        "plain_ms": _time_ms(lambda: fused_cuda.fingerprint_hashes_plain(*k1_args, 42), 3),
    }

    ref, qry = Sketch(), Sketch()
    ref.load_msh(str(work / "a.msh"))
    qry.load_msh(str(work / "b.msh"))
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
    phase_golden(work)
    launches, seqs_a = phase_main_path(dev, rng, work)
    k1, k2 = phase_main_shapes(dev, work, seqs_a)
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    k2["max_abs_err"] = max(k2["max_abs_err"], err2)

    kernels = [
        {"name": "fingerprint", "route": "cuda", "source": "fpmash_tpu_torch/csrc/fingerprint.cu",
         "replaces": "fpmash_tpu/ops/fused_pallas.py:339", "launches": launches["fingerprint"],
         **k1},
        {"name": "walk", "route": "cuda", "source": "fpmash_tpu_torch/csrc/walk.cu",
         "replaces": "fpmash_tpu/ops/walk_pallas.py:41", "launches": launches["walk"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
