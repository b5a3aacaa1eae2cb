"""Time kernels of checkouts of the port, in turns, on one card: K1-K15 and
the minmer kernel.

    python3 kernel_ab.py TREE_A TREE_B [--rounds 2] [--only k2 k4 ...]

Each tree is the root of a checkout (for example the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists, and ``.``).
Every run is a process of its own that imports ``fpmash_tpu_torch`` from
its tree, builds that tree's kernels into the tree's ``build/`` and times
each kernel with CUDA events (warm, 20 launches; 3 for the all-pairs tile)
at the main paths' shapes on inputs made from a fixed seed:

* one chunk of 16 Mi positions holding 5 000 000 random bases and zero
  padding, as the direct route ships g1: K7 at k = 21, K8 at k = 16, K6 at
  the s = 10 000 threshold, K5 at the s = 1000 one; at k = 21, K12 on the
  chunk's int32 codes, K10 on them at the s = 1000 threshold and K11 on its
  packed windows F and R; and K15 on K6's masked planes of it at s = 1000
  as ``[4096, 4096]``, with ``torch.sort`` + ``gather`` of the same planes
  beside it (``sort_library_ms``);
* the 512 000 shift windows of 100 of 256 reads of 2 000 bases: K1, K3
  (``factor_words`` ICFL_COMB), K14 (CFL_COMB) and the single-strand ICFL
  and CFL passes of the same kernel, K4 (``hash_words``) on K3's words; and
  the same windows as ``[512 000, 100]`` rows, K13
  (``fingerprint_hashes_fused(variant="inline")``) under byte4 and dna16;
* the CFL ``dist -fp`` shape: K2 over the 256 x 256 sketches of 1 000 of
  those reads and of 256 more, each read's first 1 000 window hashes (low
  32 bits, in order), as ``sketch --direct-fp`` writes them and ``dist``
  loads them;
* ``chip_smoke.N_CHUNKS`` seeded chunks of ``chip_smoke.CHUNK_LEN`` = 300
  characters, laid end to end as the ``fingerprint`` verb's generalized mode
  ships them: K3 (ICFL_COMB) at the shape of its instance for rows of
  256-1 023;
* the lyn2vec golden FASTA's shift windows (reverse complements included,
  as ``fingerprint --rev_comb true`` sends them), where the ten families' CLI
  runs launch K14: CFL_COMB and CFL_ICFL_COMB-30 (the latter also at the
  512 000 windows);
* K1-K4, K13 and K14 also through their C entry points alone
  (``*_launch_ms``: no wrapper checks, allocations or waits for the card,
  such as ``factor_words``' ``lengths.max()`` and K13's ``aminmax``), which
  times the kernel without the wrapper's host work;
* BASELINE config 4's 10 100 sketches of s = 1000, made as
  ``chip_smoke._cluster_lists`` makes them: K9 at ``dist``'s 10 000 x 100
  and at one all-pairs tile (the first ``models/distance._TILE_PAIRS // 10 000``
  rows against all 10 000), and K2 at a tile of the first 1 000 rows
  against all 10 000 (``k2_tile_ms``, 10^7 pairs);
* the minmer kernel (``ops/winnow.minmer_marks``) at its five shapes, on
  the k-mer hashes of 5 000 000 random bases (k = 21, find's -L 10 000
  and mins 100): the whole chromosome (``winnow_chrom_ms``), its first
  chunk of 1 677 starts (``winnow_chunk_ms``), a query strand of 5 000
  bases, 4 980 positions, one window (``winnow_query_ms``), 1 000 000
  positions of 3 values (``winnow_worst_ms``), and 200 000 random bases at
  k = 16, -L 1 000, mins 10 (``winnow_k16_ms``); and at a window of 3
  positions, mins 1, over the chromosome's first 1 000 000 positions
  (``winnow_w3_ms``; 200 calls a time at the small shapes, whose pace the
  wrapper's host work sets); each but the chromosome is checked against
  ``minmer_marks_plain`` before it is timed;
  beside each, the device time of the same calls by kernel
  (``winnow_*_device_ms``, ``torch.profiler``), without the host's share
  of the wrapper;
* the screen cell's read set, a FASTQ of 1 000 000 reads of 150 bases
  (``chip_smoke._fastq_bytes``, written once into ``build/``):
  ``record_stream`` of the file at k = 21 on the host clock
  (``record_stream_ms``, the median of 5 warm calls), and where the tree has
  it the record-stream kernel on the file's bytes on the card
  (``seq_stream_ms``) and its plain version (``seq_stream_plain_ms``).

Runs go A B B A in each round, so both trees meet the card in the same
states.  ``--only`` times just the keys that start with one of its
prefixes.  It prints one JSON line per run, then the card's name and power
limit as ``nvidia-smi`` gives them.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

CHUNK, BASES, K_WIDE, K_NARROW = 1 << 24, 5_000_000, 21, 16
ROOT = Path(__file__).resolve().parent
GOLDEN_FASTA = ROOT / "tests" / "golden" / "lyn2vec_basic" / "example_transcripts_genes.fa"
N_READS, READ_LEN, WINDOW = 256, 2000, 100


def _time_ms(fn, reps: int = 20) -> float:
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


def _device_ms(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``
    over ``reps`` warm calls), and their sum under ``"total"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {evt.key[:60]: evt.device_time_total / reps / 1e3
           for evt in prof.key_averages() if evt.device_time_total}
    out["total"] = sum(out.values())
    return out


def worker(tree: Path, only: list[str]) -> dict:
    """The times of one tree's kernels whose keys start with a prefix in
    ``only`` (all when it is empty), run in a process of its own."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        BASE_SET,
        CHUNK_LEN,
        N_ALL,
        N_CHUNKS,
        N_QRY,
        SCREEN_READ_LEN,
        SCREEN_READS,
        SKETCH,
        _chunk_stream,
        _fastq_bytes,
        _cluster_lists,
        _factor_launch,
        _fingerprint_launch,
        _fingerprint_rows_launch,
        _hash_words_launch,
        _walk_launch,
    )

    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import (
        _build,
        compare_cuda,
        fused_cuda,
        icfl_cuda,
        kmers,
        sort_cuda,
        walk_cuda,
        winnow,
    )
    from fpmash_tpu_torch.models.distance import _TILE_PAIRS
    from fpmash_tpu_torch.ops import kmers_cuda as kc
    from fpmash_tpu_torch.ops.kmers import chunk_threshold
    from fpmash_tpu_torch.ops.walk import pad_lists

    if not Path(_build.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.library()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(2026)
    buf = np.zeros(CHUNK, np.uint8)
    buf[:BASES] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=BASES)]
    seq = torch.from_numpy(buf).to(dev)
    t5 = chunk_threshold(CHUNK, K_WIDE, 1000)[0]
    t6 = chunk_threshold(CHUNK, K_WIDE, 10_000)[0]
    codes = torch.from_numpy(kmers._CODES).to(dev)[seq.long()]
    F, R, _ = kmers._pack_windows(torch.nn.functional.pad(codes, (0, K_WIDE - 1), value=4),
                                  CHUNK, K_WIDE)
    codes = codes.to(torch.int32)

    def shift_windows():
        reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(N_READS, READ_LEN))]
        doubled = np.concatenate([reads, reads[:, : WINDOW - 1]], axis=1)
        row = READ_LEN + WINDOW - 1
        starts = (np.arange(N_READS)[:, None] * row + np.arange(READ_LEN)[None, :]).reshape(-1)
        return (torch.from_numpy(doubled.reshape(-1).copy()).to(dev),
                torch.from_numpy(starts.astype(np.int64)).to(dev),
                torch.full((starts.size,), WINDOW, dtype=torch.int32, device=dev))

    def fp_sketches(args):
        """Each read's first SKETCH window hashes, low 32 bits, in order."""
        h1 = fused_cuda.fingerprint_hashes(*args, 42)[0] & 0xFFFFFFFF
        lists = h1.view(N_READS, READ_LEN)[:, :SKETCH].contiguous()
        return lists, torch.full((N_READS,), SKETCH, dtype=torch.int32, device=dev)

    flat, starts, lengths = shift_windows()
    windows = flat[starts[:, None] + torch.arange(WINDOW, device=dev)].contiguous()
    chunks = _chunk_stream(np.random.default_rng(CHUNK_LEN), dev)
    from fpmash_tpu_torch.models.fingerprint import extract_reads, window_stream

    golden = window_stream([s for _, s in extract_reads(str(GOLDEN_FASTA), True)], shift=True)
    golden = tuple(torch.from_numpy(a).to(dev) for a in golden[:3])

    mlo, mhi = kc.kmer_hashes_masked_planes(seq, chunk_threshold(CHUNK, K_WIDE, 1000)[0], BASES,
                                            k=K_WIDE)
    keys, payload = mhi.view(-1, sort_cuda.COLS), mlo.view(-1, sort_cuda.COLS)

    def library_sort():
        order = torch.sort(keys ^ -(1 << 31), dim=1)
        return order.values ^ -(1 << 31), torch.gather(payload, 1, order.indices)

    lists = _cluster_lists(np.random.default_rng(2026), dev, N_ALL + N_QRY, BASE_SET, SKETCH,
                           sort=True)
    ref, ref_len = pad_lists(lists[:N_ALL], dev)
    qry, qry_len = pad_lists(lists[N_ALL:], dev)
    rows = _TILE_PAIRS // N_ALL
    fp_walk = (*fp_sketches((flat, starts, lengths)), *fp_sketches(shift_windows()), SKETCH)
    tile_walk = (ref[:1000], ref_len[:1000], ref, ref_len, SKETCH)
    words = icfl_cuda.factor_words(flat, starts, lengths, "ICFL_COMB")[0]

    @functools.lru_cache(maxsize=None)
    def minmer_shapes() -> dict:
        """``(h, prev, ws, mins)`` of the minmer kernel at its five shapes
        and at a window of 3."""
        from fpmash_tpu_torch.models.sketch import SketchParams, position_hashes
        from fpmash_tpu_torch.ops.winnow import prev_occurrence

        own = np.random.default_rng(2028)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        chrom = acgt[own.integers(0, 4, size=BASES)].tobytes()
        p21 = SketchParams(kmer_size=K_WIDE, sketch_size=100, window_size=10_000, windowed=True)
        p16 = SketchParams(kmer_size=K_NARROW, sketch_size=10, window_size=1000, windowed=True)
        hc = position_hashes(chrom, p21, dev)
        values = torch.from_numpy(own.integers(0, 1 << 63, size=3, dtype=np.uint64).view(np.int64))
        hw = values[torch.from_numpy(own.integers(0, 3, size=1_000_000))].to(dev)
        h16 = position_hashes(acgt[own.integers(0, 4, size=200_000)].tobytes(), p16, dev)
        out = {}
        for key, h, ws, mins in (
                ("chrom", hc, 10_000, 100), ("chunk", hc[: 1677 + 9999], 10_000, 100),
                ("query", position_hashes(chrom[:5000], p21, dev), 4980, 100),
                ("worst", hw, 10_000, 100), ("k16", h16, 1000, 10),
                ("w3", hc[:1_000_000].contiguous(), 3, 1)):
            out[key] = (h, prev_occurrence(h), ws, mins)
        return out

    @functools.lru_cache(maxsize=None)
    def screen_fastq() -> str:
        """The screen cell's read set as a file, written once for every tree."""
        path = ROOT / "build" / "kernel_ab_screen_reads.fq"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(_fastq_bytes(np.random.default_rng(2029), SCREEN_READS,
                                         SCREEN_READ_LEN))
            tmp.replace(path)
        return str(path)

    def seq_stream_ms(plain: bool):
        """The record-stream kernel (or its plain version) on the file's bytes
        on the card; None for a tree without it."""
        try:
            from fpmash_tpu_torch.ops import seq_stream
        except ImportError:
            return None
        from fpmash_tpu_torch.device import file_to_device

        data = file_to_device(screen_fastq(), dev, seq_stream.LEADING_BLANKS)
        fn = seq_stream.seq_stream_plain if plain else seq_stream.seq_stream
        return _time_ms(lambda: fn(data, K_WIDE), reps=2 if plain else 10)

    def record_stream_ms() -> float:
        """Host wall of ``record_stream`` of the file (median of 5, warm)."""
        import time

        from fpmash_tpu_torch.models.sketch import record_stream

        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            record_stream([screen_fastq()], K_WIDE, dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls[1:]))

    timings = {
        "seq_stream_ms": lambda: seq_stream_ms(False),
        "seq_stream_plain_ms": lambda: seq_stream_ms(True),
        "record_stream_ms": record_stream_ms,
        "k2_ms": lambda: _time_ms(lambda: walk_cuda.pairwise_walk(*fp_walk)),
        "k2_launch_ms": lambda: _time_ms(_walk_launch(*fp_walk)),
        "k2_tile_ms": lambda: _time_ms(lambda: walk_cuda.pairwise_walk(*tile_walk), reps=3),
        "k4_ms": lambda: _time_ms(lambda: icfl_cuda.hash_words(words, lengths, 42)),
        "k4_launch_ms": lambda: _time_ms(_hash_words_launch(words, lengths)),
        "k9_dist_ms": lambda: _time_ms(lambda: compare_cuda.pairwise_common_denom(
            ref, ref_len, qry, qry_len, SKETCH)),
        "k9_tile_ms": lambda: _time_ms(lambda: compare_cuda.pairwise_common_denom(
            ref[:rows], ref_len[:rows], ref, ref_len, SKETCH), reps=3),
        "k15_ms": lambda: _time_ms(lambda: sort_cuda.row_sort_planes(keys, payload)),
        "sort_library_ms": lambda: _time_ms(library_sort),
        "k5_ms": lambda: _time_ms(lambda: kc.kmer_hashes_topk8_planes(seq, t5, BASES, k=K_WIDE)),
        "k6_ms": lambda: _time_ms(lambda: kc.kmer_hashes_masked_planes(seq, t6, BASES, k=K_WIDE)),
        "k7_ms": lambda: _time_ms(lambda: kc.kmer_hashes_planes(seq, k=K_WIDE)),
        "k8_ms": lambda: _time_ms(lambda: kc.kmer_hashes_planes(seq, k=K_NARROW)),
        "k10_ms": lambda: _time_ms(lambda: kc.kmer_hashes_packed_topk_planes(codes, t5, BASES,
                                                                             k=K_WIDE)),
        "k11_ms": lambda: _time_ms(lambda: kc.canonical_murmur(F, R, k=K_WIDE)),
        "k12_ms": lambda: _time_ms(lambda: kc.kmer_hashes_fused_planes(codes, k=K_WIDE)),
        "k1_ms": lambda: _time_ms(lambda: fused_cuda.fingerprint_hashes(flat, starts, lengths, 42)),
        "k1_launch_ms": lambda: _time_ms(_fingerprint_launch((flat, starts, lengths))),
        # K3 and K14: both strands, one strand, and the generalized mode's chunks
        **{key: lambda f=family, a=fargs: _time_ms(lambda: icfl_cuda.factor_words(*a, f))
           for key, family, fargs in (
               ("k3_ms", "ICFL_COMB", (flat, starts, lengths)),
               ("k14_ms", "CFL_COMB", (flat, starts, lengths)),
               ("icfl_ms", "ICFL", (flat, starts, lengths)),
               ("cfl_ms", "CFL", (flat, starts, lengths)),
               ("k3_chunks_ms", "ICFL_COMB", chunks))},
        # the same launches through the C entry point alone (no wrapper work)
        **{key: lambda f=family, a=fargs: _time_ms(_factor_launch(a, f))
           for key, family, fargs in (
               ("k3_launch_ms", "ICFL_COMB", (flat, starts, lengths)),
               ("k14_launch_ms", "CFL_COMB", (flat, starts, lengths)),
               ("k3_chunks_launch_ms", "ICFL_COMB", chunks),
               # the CFL_ICFL base at the main shape, and K14 at the families' golden
               ("cfl_icfl_comb30_launch_ms", "CFL_ICFL_COMB-30", (flat, starts, lengths)),
               ("golden_cfl_comb_launch_ms", "CFL_COMB", golden),
               ("golden_cfl_icfl_comb30_launch_ms", "CFL_ICFL_COMB-30", golden))},
        # K13 on the same windows as rows, through the wrapper and the C entry point
        **{f"k13_{pack}_ms": lambda p=pack: _time_ms(lambda: fused_cuda.fingerprint_hashes_fused(
            windows, lengths, 42, p, "inline")) for pack in ("byte4", "dna16")},
        **{f"k13_{pack}_launch_ms": lambda p=pack: _time_ms(_fingerprint_rows_launch(
            windows, lengths, p)) for pack in ("byte4", "dna16")},
        # 200 calls at the small shapes, where the wrapper's host work sets the pace
        **{f"winnow_{shape}_ms": lambda x=shape: _time_ms(
            lambda: winnow.minmer_marks(*minmer_shapes()[x]), reps=20 if x == "chrom" else 200)
           for shape in ("chrom", "chunk", "query", "worst", "k16", "w3")},
        # the same calls' device time by kernel (the wrapper's fill of the
        # marks included), from torch.profiler
        **{f"winnow_{shape}_device_ms": lambda x=shape: _device_ms(
            lambda: winnow.minmer_marks(*minmer_shapes()[x]))
           for shape in ("chrom", "chunk", "query", "worst", "k16", "w3")},
    }
    def same(fn, plain, args):
        got, want = fn(*args), plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tree}: {fn.__name__} differs from its plain version")

    # a variant tree's K2 and K4 must equal their plain versions before they are timed
    checks = {
        "k2": lambda: [same(walk_cuda.pairwise_walk, walk_cuda.pairwise_walk_plain, a)
                       for a in (fp_walk, (ref[:100], ref_len[:100], *tile_walk[2:]))],
        "k4": lambda: same(icfl_cuda.hash_words, icfl_cuda.hash_words_plain,
                           (words, lengths, 42)),
        "winnow": lambda: [same(lambda *a: [winnow.minmer_marks(*a)],
                                lambda *a: [winnow.minmer_marks_plain(*a).to(torch.uint8)],
                                minmer_shapes()[x])
                   for x in ("chunk", "query", "worst", "k16", "w3")],
    }
    selected = [key for key in timings if not only or any(key.startswith(p) for p in only)]
    for prefix, check in checks.items():
        if any(key.startswith(prefix + "_") for key in selected):
            check()
    out = {key: timings[key]() for key in selected}
    return {"tree": str(tree), **out, "k9_tile_pairs": rows * N_ALL,
            "k2_tile_pairs": tile_walk[0].shape[0] * N_ALL,
            "chunks": f"{N_CHUNKS} x {CHUNK_LEN}"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", nargs="*", default=[],
                        help="time only the keys that start with one of these prefixes")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.only)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 2
    if len(args.trees) < 2:
        parser.error("give at least two trees")
    order = []
    for _ in range(args.rounds):
        order += args.trees + args.trees[::-1]
    for tree in order:
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree),
                              "--only", *args.only],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the run of {tree} failed (exit {out.returncode})")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
