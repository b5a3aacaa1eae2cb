"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the CUDA kernels from ``fpmash_tpu_torch/csrc`` into ``build/``, holds each
kernel against its plain PyTorch version on the card, reproduces the DNA3
golden sketch, the lyn2vec goldens of all ten factorization families and
the reference's classic goldens (``reads.msh``, ``genomes.dist``,
``screen_ref.txt``) through the CLI, and drives four main paths at the size
users run: two FASTAs of 256 reads x 2 000 bases (``sketch --direct-fp`` on
each, CFL and then ICFL_COMB, then ``dist -fp`` over the 65 536 pairs); the
classic k-mer MinHash workflow at E. coli scale (three 5 Mbase genomes and a
50 Mbase read set: ``sketch``, ``sketch -r -m 2``, ``sketch -s 10000``,
``sketch -k 16``, ``dist``, ``screen``); and BASELINE config 4, all-pairs
distance over 10 000 sketches of s = 1000 (the sorted comparison K9 over
10^8 pairs, held pair for pair against the walk K2; ``dist`` of 10 000 x
100 sketches, ``triangle`` and ``triangle -fp`` over 1 000).  The
multi-device layer (``fpmash_tpu_torch/parallel/``) runs the sharded routes
on an explicit mesh of 4 shards (one a card where there are several, else
all 4 on cuda:0), each held byte for byte against one device: BASELINE
config 5 (1 000 000 reads of 150 bases, ``sketch -r -m 2`` and ``sketch
-r``, then ``dist``), both fingerprint paths' FASTAs, config 4's 10^8
pairs, ``dist``, ``triangle`` and ``triangle -fp``, ``dist -fp`` through
``sharded_all_pairs_walk``, ``pipeline_step``, and the CLI under
``FPMASH_DEVICES``.  The native host helpers (``fpmash_tpu_torch/native/``,
built with g++ at first use) run last: config 5's FASTQ and the classic read
set parsed by the native and the Python reader (same records, walls, peak
resident memory), ``sketch -r -m 2`` of config 5's FASTQ through the CLI
from the file (K5), the CRLF and whitespace edge files sketched and
fingerprinted on the card against digests of the JAX CLI's outputs, and
``fingerprint --type generalized ICFL_COMB`` of 2 000 reads of 10 000 bases
at ``--split 2000`` (every chunk on the host factorizer) and ``--split 300``
(K3).  The five
kernels that the JAX package keeps unrouted run through the entry points of
the JAX functions they replace, at those paths' shapes and on their data:
K13 (``fingerprint_hashes_fused(variant="inline")``) on the CFL path's
512 000 windows as rows, under byte4 and dna16, against K1; and on the
classic path's 16 Mi-position chunk of g1 (k = 21, s = 1000) K11
(``canonical_murmur``) against K7's hashes, K12 (``kmer_hashes_fused_planes``,
wrapping and not) against K7's planes, K10 (``kmer_hashes_packed_topk_planes``)
against K5's survivors, and K15 (``row_sort_planes``) on K6's masked planes
against ``torch.sort``.  So all fifteen kernels are held against their plain
versions; the k-mer kernels (K5-K8, K10-K12) also on a tile-edge set
(lengths on and one off the kernels' tiles, invalid codes on the tile
edges, a misaligned view).  The minmer kernel (``csrc/winnow.cu``, which
replaces the JAX package's XLA jit of the selection) runs in ``sketch -W``
and ``find`` and is held against its plain version over the whole 5 Mbase
chromosome and at the path's other shapes.  Every phase passes or raises;
nothing is caught.

The last three lines of standard output are the kernels' JSON record
(launch counts from the main paths, for the Duval base of
``factor_words`` from the families' CLI runs, for the five unrouted kernels
from their phases, which name the ``entry_point``; exact-match errors;
kernel and plain times at one shape, for K9 ``dist``'s with its ``pairs``
and its 10^8-pair time beside it, for K2 the CFL path's 256 x 256 sketches
with its 10^8-pair time and bound (``all_pairs_ms``, ``all_pairs_bound_ms``)
and its random lists (``random_lists``) beside it; each kernel's bound, the
least time the card could take for its work, from its bytes and integer
operations at that shape; for K15 the time of ``torch.sort`` and
``gather``; for the minmer kernel its times on one chunk of 1 677 starts,
on 1 000 000 positions of 3 values, on a query strand and on the plasmid
at -k 16 (``chunk``, ``worst``, ``query``, ``plasmid_k16``), its launches
by shape and the windowed phase's peak device memory; for K1-K4,
K13 and K14 the time of their C entry point alone
(``launch_ms``) beside the wrapper's, K13's under dna16 beside byte4
(``dna16_ms``, ``dna16_launch_ms``),
and their times at the generalized mode's 300-character chunks, at the
golden's windows and with every window the same), the
card's ``name, power.limit`` as ``nvidia-smi`` gives them, and
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


#: the card's memory rate, bytes/s (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations/s: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT_OPS_PER_S = 132 * 64 * 1.98e9
#: 32-bit operations of MurmurHash3_x64_128 per 8-byte word it mixes (two
#: 64-bit multiplies, a rotate, xors and the state update), and of its
#: finalization (two fmix64 and the sums)
MURMUR_WORD_OPS, MURMUR_FINAL_OPS = 20, 40


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its 32-bit integer operations over the integer rate.
    No single PyTorch call computes these kernels' functions but K15's (a
    row sort, whose phase times ``torch.sort`` and ``gather``), so
    ``library_ms`` is None here."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def _lists_bytes(ref, qry) -> int:
    """Two list sets ``int64 [n, S]`` with ``int32`` lengths read once, and
    ``int32`` common and denom of every pair written once."""
    R, Q = ref.shape[0], qry.shape[0]
    return (ref.numel() + qry.numel()) * 8 + (R + Q) * 4 + R * Q * 8


def _hash_ops(counts, rows: int) -> int:
    """Operations of MurmurHash3 over ``rows`` vectors of ``counts`` words."""
    return MURMUR_WORD_OPS * int(counts.clamp(min=0).sum()) + MURMUR_FINAL_OPS * rows


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


#: the ``fingerprint`` verb's generalized mode: reads cut into chunks of
#: CHUNK_LEN characters, sent end to end (models/fingerprint.py:
#: fingerprint_long_reads); N_CHUNKS of them reach factor_words' instance for
#: rows of 256-1 023 (uint16 scratch) and its device-memory route
N_CHUNKS, CHUNK_LEN = 131_072, 300


def _chunk_stream(rng, dev):
    """``(flat, starts, lengths)`` on ``dev``: N_CHUNKS seeded ACGT chunks of
    CHUNK_LEN, end to end."""
    import numpy as np
    import torch

    flat = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=N_CHUNKS * CHUNK_LEN)]
    starts = np.arange(N_CHUNKS, dtype=np.int64) * CHUNK_LEN
    lengths = np.full(N_CHUNKS, CHUNK_LEN, np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (flat, starts, lengths))


def _factor_bound(args, words, ok) -> dict:
    """K3's and K14's bound: the stream, starts and lengths in, boundary words
    and ok out; a COMB family reads each character at least once on each strand."""
    return _bound(args[0].numel() + args[1].numel() * (8 + 4) + words.numel() * 4 + ok.numel(),
                  2 * int(args[2].clamp(min=0).sum()))


def _factor_launch(args, family: str):
    """A call of factor_words' C entry point alone, as the wrapper makes it
    for ``args`` (outputs allocated once, no checks, no ``lengths.max()``,
    which waits for the card): times the kernel without the wrapper's host work."""
    import torch

    from fpmash_tpu_torch.ops import icfl_cuda
    from fpmash_tpu_torch.ops._build import check, library
    from fpmash_tpu_torch.ops.factorize import plan
    from fpmash_tpu_torch.ops.lyndon import words_width

    base, threshold, comb = plan(family)
    max_len = int(args[2].max())
    B, W = args[1].numel(), words_width(max_len)
    words = torch.empty((B, W), dtype=torch.int32, device=args[0].device)
    ok = torch.empty(B, dtype=torch.bool, device=args[0].device)
    fn = library().fpmash_factor_words
    call = (args[0].data_ptr(), args[0].numel(), args[1].data_ptr(), args[2].data_ptr(), B,
            icfl_cuda._BASES[base], threshold or 0, int(comb), max_len, words.data_ptr(), W,
            ok.data_ptr(), torch.cuda.current_stream(args[0].device).cuda_stream)
    check(fn(*call), f"factor_words {family} launch")
    return lambda keep=(words, ok): fn(*call)  # the outputs live as long as the call


def _fingerprint_launch(args):
    """A call of K1's C entry point alone for ``args`` (outputs allocated
    once, no checks): times the kernel without the wrapper's host work."""
    import torch

    from fpmash_tpu_torch.ops._build import check, library

    flat, starts, lengths = args
    B = starts.numel()
    outs = [torch.empty(B, dtype=dt, device=flat.device)
            for dt in (torch.int64, torch.int64, torch.int32)]
    fn = library().fpmash_fingerprint
    call = (flat.data_ptr(), flat.numel(), starts.data_ptr(), lengths.data_ptr(), B, 42,
            *(o.data_ptr() for o in outs), torch.cuda.current_stream(flat.device).cuda_stream)
    check(fn(*call), "fingerprint launch")
    return lambda keep=outs: fn(*call)


def _fingerprint_rows_launch(rows, lengths, pack: str):
    """A call of K13's C entry point alone for ``int32`` ``lengths`` of
    ``rows`` under ``pack`` (outputs allocated once; no checks and no
    ``aminmax`` of the lengths, which waits for the card)."""
    import torch

    from fpmash_tpu_torch.ops import fused_cuda
    from fpmash_tpu_torch.ops._build import check, library

    B, L = rows.shape
    outs = [torch.empty(B, dtype=dt, device=rows.device)
            for dt in (torch.int64, torch.int64, torch.int32)]
    fn = library().fpmash_fingerprint_rows
    call = (rows.data_ptr(), B, L, lengths.data_ptr(), fused_cuda.PACKS[pack], 42,
            *(o.data_ptr() for o in outs), torch.cuda.current_stream(rows.device).cuda_stream)
    check(fn(*call), f"fingerprint rows {pack} launch")
    return lambda keep=outs: fn(*call)


def _walk_launch(ref, ref_len, qry, qry_len, s: int):
    """A call of K2's C entry point alone for these lists (outputs allocated
    once, no checks): times the kernel without the wrapper's host work."""
    import torch

    from fpmash_tpu_torch.ops._build import check, library

    (R, S1), (Q, S2) = ref.shape, qry.shape
    outs = [torch.empty((R, Q), dtype=torch.int32, device=ref.device) for _ in range(2)]
    fn = library().fpmash_walk
    call = (ref.data_ptr(), ref_len.data_ptr(), R, S1, qry.data_ptr(), qry_len.data_ptr(), Q, S2,
            min(s, 2**31 - 1), *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(ref.device).cuda_stream)
    check(fn(*call), "walk launch")
    return lambda keep=outs: fn(*call)


def _walk_ops(ref_len, qry_len, s: int) -> int:
    """K2's operations: a walk runs at least min(s, la, lb) steps, a 64-bit
    compare and a count each (3 operations)."""
    import torch

    la = ref_len.long().clamp(min=0).clamp(max=s)
    lb = qry_len.long().clamp(min=0).clamp(max=s)
    # sum over pairs of min(la, lb), by sorting one side
    lb_sorted = torch.sort(lb).values
    below = torch.cumsum(lb_sorted, 0)
    k = torch.searchsorted(lb_sorted, la, right=True)
    total = torch.where(k > 0, below[(k - 1).clamp(min=0)], 0) + la * (lb.numel() - k)
    return 3 * int(total.sum())


def _hash_words_launch(words, lengths):
    """A call of K4's C entry point alone (outputs allocated once, no checks)."""
    import torch

    from fpmash_tpu_torch.ops._build import check, library

    B, W = words.shape
    outs = [torch.empty(B, dtype=dt, device=words.device)
            for dt in (torch.int64, torch.int64, torch.int32)]
    fn = library().fpmash_hash_words
    call = (words.data_ptr(), W, lengths.data_ptr(), B, 42, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(words.device).cuda_stream)
    check(fn(*call), "hash_words launch")
    return lambda keep=outs: fn(*call)


def _load_model(name: str):
    """A numpy model of a kernel's steps from ``tests/`` (its JAX imports
    sit inside its JAX tests, so loading it loads no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"test_torch_{name}.py")
    model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(model)
    return model


def _factor_steps(args, family: str, pick) -> float:
    """Automaton steps a character (both strands) on the windows ``pick``, as
    the numpy model of csrc/factor_words.cu (tests/test_torch_factor_body.py,
    which imports JAX only inside its JAX tests) counts them: Duval steps,
    ICFL scan, chain and merge steps.  A count, not a measurement: it is
    printed beside the times and kept out of the ``kernels`` line."""
    flat, starts, lengths = (a.cpu().numpy() for a in args)
    _, _, steps, _ = _load_model("factor_body").factor_words_model(flat, starts[pick],
                                                                   lengths[pick], family)
    return sum(steps.values()) / max(int(lengths[pick].sum()), 1)


def _fingerprint_steps(args, pick) -> float:
    """Duval steps a character of K1 on the windows ``pick``, as the numpy
    model of csrc/fingerprint.cu (tests/test_torch_fingerprint_body.py)
    counts them.  A count, not a measurement: printed, not recorded."""
    flat, starts, lengths = (a.cpu().numpy() for a in args)
    steps = _load_model("fingerprint_body").fingerprint_model(flat, starts[pick],
                                                              lengths[pick])[3]
    return steps["duval"] / max(int(lengths[pick].sum()), 1)


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
    2 000 hashes, s = 1000, 16 rows of each side cut short.  Returns the
    largest error and K2's times and bound at this shape."""
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
    rec = {
        "shape": f"{n} x {n} lists of {width}, s = {s}",
        "ms": _time_ms(lambda: walk_cuda.pairwise_walk(*args), 20),
        "launch_ms": _time_ms(_walk_launch(*args), 20),
        "plain_ms": _time_ms(lambda: walk_cuda.pairwise_walk_plain(*args), 3),
        "bound_ms": _bound(_lists_bytes(args[0], args[2]), _walk_ops(args[1], args[3], s))[
            "bound_ms"],
    }
    print(
        f"K2 walk: {rec['shape']}, equal to the plain version; kernel {rec['ms']:.4f} ms "
        f"({rec['launch_ms']:.4f} ms through the C entry point), plain {rec['plain_ms']:.4f} "
        f"ms, bound {rec['bound_ms']:.4f} ms"
    )
    return err, rec


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
    from fpmash_tpu_torch.ops import (
        compare_cuda,
        fused_cuda,
        icfl_cuda,
        kmers_cuda,
        sort_cuda,
        walk_cuda,
        winnow,
    )

    fused_cuda.LAUNCHES = 0
    winnow.LAUNCHES = 0
    winnow.LAUNCH_SHAPES.clear()
    fused_cuda.INLINE_LAUNCHES = 0
    walk_cuda.LAUNCHES = 0
    compare_cuda.LAUNCHES = 0
    sort_cuda.LAUNCHES = 0
    icfl_cuda.LAUNCHES.update(dict.fromkeys(icfl_cuda.LAUNCHES, 0))
    kmers_cuda.LAUNCHES.update(dict.fromkeys(kmers_cuda.LAUNCHES, 0))
    fingerprint.SCALAR_ROWS.update(dict.fromkeys(fingerprint.SCALAR_ROWS, 0))


def _launches() -> dict:
    from fpmash_tpu_torch.ops import (
        compare_cuda,
        fused_cuda,
        icfl_cuda,
        kmers_cuda,
        sort_cuda,
        walk_cuda,
        winnow,
    )

    out = {"fingerprint": fused_cuda.LAUNCHES, "fingerprint_inline": fused_cuda.INLINE_LAUNCHES,
           "walk": walk_cuda.LAUNCHES, "compare": compare_cuda.LAUNCHES,
           "row_sort": sort_cuda.LAUNCHES, "winnow": winnow.LAUNCHES}
    for key, n in icfl_cuda.LAUNCHES.items():
        out["hash_words" if key == "hash_words" else f"factor_words:{key}"] = n
    for key, n in kmers_cuda.LAUNCHES.items():
        out[f"kmer:{key}"] = n
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
        raise AssertionError(f"the {family} main path sent rows to the host: {scalar_rows}")

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
          f"rows factorized on the host {scalar_rows}")
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
        "launch_ms": _time_ms(_fingerprint_launch(k1_args), 50),
        "plain_ms": _time_ms(lambda: fused_cuda.fingerprint_hashes_plain(*k1_args, 42), 3),
        # the stream, starts and lengths in, h1, h2 and count out; Duval reads
        # each character once, then MurmurHash3 of the factor lengths
        **_bound(k1_args[0].numel() + starts.numel() * (8 + 4 + 20),
                 int(k1_args[2].clamp(min=0).sum()) + _hash_ops(want[2], starts.numel())),
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
        "launch_ms": _time_ms(_walk_launch(*k2_args), 50),
        "plain_ms": _time_ms(lambda: walk_cuda.pairwise_walk_plain(*k2_args), 3),
        **_bound(_lists_bytes(k2_args[0], k2_args[2]), _walk_ops(k2_args[1], k2_args[3], s)),
    }
    sample = np.random.default_rng(8).choice(len(starts), 256, replace=False)
    per_char = _fingerprint_steps(k1_args, sample)
    chars = int(k1_args[2].sum())
    # lanes in step: every window the same 100 characters (divergence measured)
    same = (k1_args[0], torch.full_like(starts, int(starts[0])), k1_args[2])
    k1["same_window"] = {"launch_ms": _time_ms(_fingerprint_launch(same), 50)}
    same_per_char = _fingerprint_steps(same, [0])
    print(f"main-path shapes: K1 {k1['launch_ms']:.4f} ms through the C entry point alone; "
          f"{per_char:.4f} Duval steps a character (counted by the numpy model on 256 "
          f"windows): {k1['launch_ms'] * 1e6 / (chars * per_char):.6f} ns of the card a step; "
          f"every window the same: {k1['same_window']['launch_ms']:.4f} ms, "
          f"{same_per_char:.4f} steps a character, "
          f"{k1['same_window']['launch_ms'] * 1e6 / (chars * same_per_char):.6f} ns a step")
    print(f"main-path shapes: K1 at {len(starts)} windows kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms; K2 at {len(ref)}x{len(qry)} sketches of "
          f"{k2_args[0].shape[1]} kernel {k2['ms']:.4f} ms ({k2['launch_ms']:.4f} ms through "
          f"the C entry point), plain {k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms; "
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
    false``); the gzipped ones all of them (``--rev_comb true``).  Then K14
    against its plain version and timed at the shape of these runs (the
    golden's shift windows as ``fingerprint --rev_comb true`` sends them),
    for each of its bases.  Returns the launches of this phase and K14's
    times there."""
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

    import torch

    from fpmash_tpu_torch.models.fingerprint import extract_reads, window_stream
    from fpmash_tpu_torch.ops import icfl_cuda

    flat, starts, lengths, _ = window_stream([s for _, s in extract_reads(str(fasta), True)],
                                             shift=True)
    args = tuple(torch.from_numpy(a).to("cuda") for a in (flat, starts, lengths))
    timed = {"windows": len(starts)}
    for family in ("CFL_COMB", "CFL_ICFL_COMB-30"):  # the cfl and cfl_icfl bases
        got = icfl_cuda.factor_words(*args, family)
        want = icfl_cuda.factor_words_plain(*args, family)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"factor_words {family} differs from the plain version on "
                                 "the golden")
        timed[family] = {"ms": _time_ms(lambda f=family: icfl_cuda.factor_words(*args, f), 20),
                         "launch_ms": _time_ms(_factor_launch(args, family), 20),
                         "bound_ms": _factor_bound(args, *got)["bound_ms"]}
    print(f"golden: K14 at the golden's {len(starts)} shift windows: "
          + "; ".join(f"{f} {timed[f]['ms']:.4f} ms ({timed[f]['launch_ms']:.4f} ms through the "
                      f"C entry point; bound {timed[f]['bound_ms']:.4f} ms)"
                      for f in ("CFL_COMB", "CFL_ICFL_COMB-30")))
    return launches, timed


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
    sample = np.random.default_rng(8).choice(len(args[1]), 256, replace=False)
    out, steps = {}, {}
    for name, family in (("k3", "ICFL_COMB"), ("k14", "CFL_COMB")):
        got = icfl_cuda.factor_words(*args, family)
        want = icfl_cuda.factor_words_plain(*args, family)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"factor_words {family} differs from the plain version on a.fasta")
        if not bool(got[1].all()):
            raise AssertionError(f"factor_words {family}: {int((~got[1]).sum())} rows not ok")
        # the time through the wrapper, as for every kernel; the C entry
        # point's alone (no lengths.max(), which waits for the card) beside it
        out[name] = {
            "max_abs_err": _max_abs_err(zip(got, want)),
            "ms": _time_ms(lambda f=family: icfl_cuda.factor_words(*args, f), 20),
            "launch_ms": _time_ms(_factor_launch(args, family), 20),
            "plain_ms": _time_ms(lambda f=family: icfl_cuda.factor_words_plain(*args, f), 1),
            **_factor_bound(args, *got),
        }
        # lanes in step: every window the same 100 characters, so that no lane
        # of a warp waits for another (warp divergence measured, not modelled)
        same = (args[0], torch.full_like(args[1], int(args[1][0])), args[2])
        out[name]["same_window"] = {"launch_ms": _time_ms(_factor_launch(same, family), 20)}
        # counted by the numpy model, not measured: printed, not recorded
        steps[name] = (_factor_steps(args, family, sample), _factor_steps(same, family, [0]))
        if family == "ICFL_COMB":
            words = got[0]

    # K3 at the generalized mode's shape, against its plain version on a sample
    chunks = _chunk_stream(np.random.default_rng(CHUNK_LEN), dev)
    got = icfl_cuda.factor_words(*chunks, "ICFL_COMB")
    pick = np.random.default_rng(9).choice(N_CHUNKS, 2048, replace=False)
    pick = torch.from_numpy(pick).to(dev)
    sample = (chunks[0], chunks[1][pick], chunks[2][pick])
    want = icfl_cuda.factor_words_plain(*sample, "ICFL_COMB")
    if not (torch.equal(got[0][pick], want[0]) and torch.equal(got[1][pick], want[1])):
        raise AssertionError("factor_words ICFL_COMB differs from the plain version on the chunks")
    if not bool(got[1].all()):
        raise AssertionError(f"factor_words ICFL_COMB: {int((~got[1]).sum())} chunks not ok")
    out["k3"]["max_abs_err"] = max(out["k3"]["max_abs_err"],
                                   _max_abs_err([(got[0][pick], want[0]), (got[1][pick], want[1])]))
    out["k3"]["chunks"] = {
        "shape": f"{N_CHUNKS} x {CHUNK_LEN}",
        "ms": _time_ms(lambda: icfl_cuda.factor_words(*chunks, "ICFL_COMB"), 10),
        "launch_ms": _time_ms(_factor_launch(chunks, "ICFL_COMB"), 10),
        "plain_ms_2048_rows": _time_ms(lambda: icfl_cuda.factor_words_plain(*sample, "ICFL_COMB"),
                                       1),
        "bound_ms": _factor_bound(chunks, *got)["bound_ms"],
    }

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
        "launch_ms": _time_ms(_hash_words_launch(words, args[2]), 50),
        "plain_ms": _time_ms(lambda: icfl_cuda.hash_words_plain(words, args[2], 42), 3),
        # words and lengths in, h1, h2 and count out; one operation a word to
        # find the boundaries, then MurmurHash3 of the factor lengths
        **_bound(words.numel() * 4 + args[2].numel() * (4 + 20),
                 words.numel() + _hash_ops(got[2], args[2].numel())),
    }
    for family in ("ICFL", "CFL"):  # one pass of each base, for reference
        ms = _time_ms(lambda f=family: icfl_cuda.factor_words(*args, f), 20)
        print(f"main-path shapes: factor_words {family} at {len(args[1])} windows {ms:.4f} ms "
              f"({_time_ms(_factor_launch(args, family), 20):.4f} ms through the C entry point)")
    chars = int(args[2].sum())
    for name in ("k3", "k14"):
        rec, same = out[name], out[name]["same_window"]["launch_ms"]
        per_char, same_per_char = steps[name]
        print(f"main-path shapes: {name} {rec['ms']:.4f} ms through the wrapper, "
              f"{rec['launch_ms']:.4f} ms through the C entry point alone; "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"{per_char:.4f} automaton steps a character, both strands (counted by the numpy "
              f"model on 256 windows): {rec['launch_ms'] * 1e6 / (chars * per_char):.6f} ns "
              f"of the card a step; every window the same: {same:.4f} ms, "
              f"{same_per_char:.4f} steps a character, "
              f"{same * 1e6 / (chars * same_per_char):.6f} ns a step")
    c = out["k3"]["chunks"]
    print(f"main-path shapes: K3 (factor_words ICFL_COMB) at {c['shape']} chunks kernel "
          f"{c['ms']:.4f} ms ({c['launch_ms']:.4f} ms through the C entry point), plain "
          f"{c['plain_ms_2048_rows']:.4f} ms for 2048 of them, bound {c['bound_ms']:.4f} ms; "
          "the sample equal to the plain version")
    print(f"main-path shapes: at {len(args[1])} windows K3 (factor_words ICFL_COMB) kernel "
          f"{out['k3']['ms']:.4f} ms, plain {out['k3']['plain_ms']:.4f} ms; K14 (factor_words "
          f"CFL_COMB) kernel {out['k14']['ms']:.4f} ms, plain {out['k14']['plain_ms']:.4f} ms; "
          f"K4 (hash_words) kernel {out['k4']['ms']:.4f} ms ({out['k4']['launch_ms']:.4f} ms "
          f"through the C entry point), plain {out['k4']['plain_ms']:.4f} ms, bound "
          f"{out['k4']['bound_ms']:.4f} ms;"
          " all equal to the plain versions")
    return out["k3"], out["k4"], out["k14"]


# ---------------------------------------------------------------------- #
# the classic k-mer MinHash path: K5, K6, K7, K8
# ---------------------------------------------------------------------- #

#: the classic main path: three genomes of GENOME_LEN bases (E. coli scale)
#: and reads of SHORT_READ bases at COVERAGE x of the first, 1 % errors
GENOME_LEN, SHORT_READ, COVERAGE = 5_000_000, 150, 10
#: the kernels the classic main path must launch (keys of _launches())
CLASSIC_PATH_KERNELS = ("kmer:topk8", "kmer:masked", "kmer:planes_k16", "kmer:planes_k32",
                        "compare")


def _mixed_dna(rng, n: int):
    """ACGT bytes with lowercase stretches, and N, IUPAC codes and NUL sprinkled in."""
    import numpy as np

    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()
    for start in rng.integers(0, n, size=n // 400):
        seq[start : start + int(rng.integers(5, 60))] += 32
    bad = rng.random(n) < 0.01
    seq[bad] = np.frombuffer(b"NRYKM\x00n", np.uint8)[rng.integers(0, 7, size=int(bad.sum()))]
    return seq


def _kmer_compare(seq, k: int, cuts, **flags) -> dict:
    """The k-mer kernels at ``k`` against their plain versions on ``seq``:
    the planes always, the masked and top-8 kernels at each ``(t_hi,
    length)`` of ``cuts`` when 16 < k.  Returns the errors by ``LAUNCHES``
    key; raises on any difference."""
    import torch

    from fpmash_tpu_torch.ops import kmers_cuda as kc

    kw = dict(k=k, seed=42, **flags)
    runs = [("planes_k16" if k <= 16 else "planes_k32", kc.kmer_hashes_planes,
             kc.kmer_hashes_planes_plain, ())]
    if k > 16:
        for cut in cuts:
            runs.append(("masked", kc.kmer_hashes_masked_planes,
                         kc.kmer_hashes_masked_planes_plain, cut))
            runs.append(("topk8", kc.kmer_hashes_topk8_planes,
                         kc.kmer_hashes_topk8_planes_plain, cut))
    errs = {}
    for key, kernel, plain, cut in runs:
        got = kernel(seq, *cut, **kw)
        want = plain(seq, *cut, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{key} (k={k}, {flags}, cut {cut}) differs from its plain version")
        errs[key] = max(errs.get(key, 0.0), _max_abs_err(zip(got, want)))
    return errs


#: positions a block of the k-mer kernels stages and hashes (csrc/kmer_hash.cu kTile)
KMER_TILE = 4096


def _tile_edge_dna(rng, n: int):
    """:func:`_mixed_dna` with N on both sides of every tile edge, 31 past it
    (the halo's last position) and at the end."""
    seq = _mixed_dna(rng, n)
    for edge in range(KMER_TILE, n + 1, KMER_TILE):
        for d in (-1, 0, 31):
            if 0 <= edge + d < n:
                seq[edge + d] = ord("N")
    seq[-1] = ord("n")
    return seq


def _kmer_tile_edges(dev, rng) -> dict:
    """The tile-edge set: K5-K8 on lengths of 4 tiles and one off them (and
    a view that is not 16-byte aligned) at k = 1, 16, 17, 21 and 32; K12 on
    their codes with codes 5-7 on the tile edges (4 tiles = one block of the
    TPU layout, so its last windows wrap to the head); K10 on the same codes
    at k = 17, 21, 32; K11 on their packed windows.  Returns the errors by
    ``LAUNCHES`` key; raises on any difference."""
    import torch

    from fpmash_tpu_torch.ops import kmers
    from fpmash_tpu_torch.ops import kmers_cuda as kc
    from fpmash_tpu_torch.ops.kmers import chunk_threshold

    errs = {}

    def note(key, got, want, what):
        torch.cuda.synchronize()
        _check_equal(what, got, want)
        errs[key] = max(errs.get(key, 0.0), _max_abs_err(zip(got, want)))

    for n in (4 * KMER_TILE - 1, 4 * KMER_TILE, 4 * KMER_TILE + 1, KMER_TILE + 5):
        full = torch.from_numpy(_tile_edge_dna(rng, n + 3)).to(dev)
        seq = full[3:] if n == KMER_TILE + 5 else full[:n]  # the last: misaligned
        codes = torch.from_numpy(kmers._CODES).to(dev)[kmers._fold_case(seq, False).long()]
        codes = codes.to(torch.int32)
        if n == KMER_TILE + 5:
            codes = torch.cat([codes[:1], codes])[1:]
        for edge in range(KMER_TILE, n, KMER_TILE):
            codes[edge - 1], codes[edge] = 5, 7
        codes[-1] = 6
        for k, flags in ((1, {}), (16, {}), (17, {}), (21, dict(preserve_case=True)), (21, {}),
                         (32, dict(noncanonical=True))):
            cuts = ((chunk_threshold(n, k, 1000)[0], n), (0x08000000, n - 777),
                    (0xFFFFFFFF, n - 1))
            for key, e in _kmer_compare(seq, k, cuts, **flags).items():
                errs[key] = max(errs.get(key, 0.0), e)
            kw = dict(k=k, noncanonical=flags.get("noncanonical", False))
            note("codes_planes", kc.kmer_hashes_fused_planes(codes, **kw),
                 kc.kmer_hashes_fused_planes_plain(codes, **kw), f"K12 at n = {n}, k = {k}")
            F, R, _ = kmers._pack_windows(
                torch.nn.functional.pad(codes, (0, k - 1), value=4).long(), n, k)
            note("canonical_murmur", (kc.canonical_murmur(F, R, **kw),),
                 (kc.canonical_murmur_plain(F, R, **kw),), f"K11 at n = {n}, k = {k}")
            if k > 16:
                for cut in cuts:
                    note("topk_groups", kc.kmer_hashes_packed_topk_planes(codes, *cut, **kw),
                         kc.kmer_hashes_packed_topk_planes_plain(codes, *cut, **kw),
                         f"K10 at n = {n}, k = {k}, cut {cut}")
    return errs


def phase_kmer_kernels(dev, rng):
    """K5-K8 against their plain versions on 1 Mi mixed positions at k = 16,
    21 and 32, canonical or not, case folded or kept; the masked and top-8
    kernels at the s = 1000 threshold, at a dense one that overflows groups
    and at the saturated one, with cut lengths.  64 of K7's hashes against
    the scalar MurmurHash3 of the canonical k bytes.  Then the tile-edge set
    of :func:`_kmer_tile_edges` (K5-K8, K10-K12).  Returns the errors by
    ``LAUNCHES`` key."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import kmers_cuda
    from fpmash_tpu_torch.ops.kmers import chunk_threshold, complement_table
    from fpmash_tpu_torch.scalar.murmur3 import hash_bytes

    n = 1 << 20
    host = _mixed_dna(rng, n)
    seq = torch.from_numpy(host).to(dev)
    errs = {}
    for k, flags in ((16, {}), (16, dict(noncanonical=True, preserve_case=True)), (21, {}),
                     (21, dict(preserve_case=True)), (32, {}), (32, dict(noncanonical=True))):
        cuts = ((chunk_threshold(n, k, 1000)[0], n), (0x08000000, n - 777), (0xFFFFFFFF, n - 1))
        for key, e in _kmer_compare(seq, k, cuts, **flags).items():
            errs[key] = max(errs.get(key, 0.0), e)

    lo, hi, valid = kmers_cuda.kmer_hashes_planes(seq, k=21)
    h = kmers_cuda.join_planes(lo, hi).cpu().numpy().view(np.uint64)
    text = np.where((host > 96) & (host < 123), host - 32, host)
    ctab = complement_table()
    probe = rng.choice(np.flatnonzero(valid.cpu().numpy()), 64, replace=False)
    for p in probe:
        kmer = bytes(text[p : p + 21])
        rc = bytes(ctab[np.frombuffer(kmer, np.uint8)][::-1])
        if int(h[p]) != hash_bytes(min(kmer, rc), seed=42):
            raise AssertionError(f"K7 position {p} differs from the scalar MurmurHash3")
    for key, e in _kmer_tile_edges(dev, rng).items():
        errs[key] = max(errs.get(key, 0.0), e)
    print(f"K5-K8: {n} mixed positions at k = 16, 21, 32 equal to the plain versions (masked "
          f"and top-8 at 3 thresholds each); {len(probe)} K7 hashes equal the scalar oracle; "
          f"K5-K8 and K10-K12 equal on the tile-edge set (lengths {4 * KMER_TILE} +- 1, "
          "a misaligned view, k = 1 to 32)")
    return errs


def phase_classic_goldens(work: Path):
    """The reference's classic goldens on cuda through the CLI: ``sketch -r
    -I reads reads1.fastq reads2.fastq`` equals ``reads.msh`` (hashes,
    counts, length 502 359, comment), ``dist`` of the three genome sketches
    against it prints ``genomes.dist`` (through K9), and ``screen`` of the
    genome sketches against the two FASTQs prints ``screen_ref.txt``.  The
    read set has under 2 Mi bases, so it takes the pool route (K7).
    Returns this path's launches."""
    import io

    import numpy as np

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models.sketch import Sketch
    from fpmash_tpu_torch.utils.msh import read_msh

    new = ROOT / "tests" / "golden" / "new_data"
    ref = ROOT / "tests" / "golden" / "mash_ref"
    out = work / "classic_golden"
    out.mkdir(parents=True, exist_ok=True)
    genomes = Sketch()
    for i in (1, 2, 3):
        genomes.load_msh(str(ref / f"genome{i}.fna.msh"))
        genomes.references[-1].name = f"genome{i}.fna"
    genomes.write_msh(str(out / "genomes.msh"))

    _reset_counts()
    rc = main(["sketch", "-r", "-I", "reads", str(new / "reads1.fastq"), str(new / "reads2.fastq"),
               "-o", str(out / "reads"), "--device", "cuda"])
    assert rc == 0, rc
    printed, screened = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main(["dist", str(out / "genomes.msh"), str(out / "reads.msh"), "--device", "cuda"])
    assert rc == 0, rc
    with contextlib.redirect_stdout(screened), contextlib.redirect_stderr(io.StringIO()):
        rc = main(["screen", str(out / "genomes.msh"), str(new / "reads1.fastq"),
                   str(new / "reads2.fastq"), "--device", "cuda"])
    assert rc == 0, rc
    launches = _launches()
    if launches["kmer:planes_k32"] < 2 or launches["compare"] < 1:
        raise AssertionError(f"the goldens did not launch K7 (sketch, screen) and K9: {launches}")

    mine = read_msh(str(out / "reads.msh")).references[0]
    gold = read_msh(str(new / "reads.msh")).references[0]
    # the golden's comment carries a stray \r from the reference's CRLF input
    if (mine.name, mine.length, mine.comment) != (gold.name, gold.length,
                                                  gold.comment.replace("\r", "")):
        raise AssertionError("sketch -r: name, length or comment differ from reads.msh")
    if not (np.array_equal(mine.hashes64, gold.hashes64)
            and np.array_equal(mine.counts32, gold.counts32)):
        raise AssertionError("sketch -r: hashes or counts differ from reads.msh")
    if printed.getvalue() != (ref / "genomes.dist").read_text():
        raise AssertionError("dist genomes.msh reads.msh differs from genomes.dist")
    if screened.getvalue() != (ref / "screen_ref.txt").read_text():
        raise AssertionError("screen genomes.msh reads1.fastq reads2.fastq differs from screen_ref.txt")
    print(f"golden: sketch -r on cuda equals reads.msh (length {mine.length}, "
          f"{len(mine.hashes64)} hashes and counts); dist prints genomes.dist; screen prints "
          f"screen_ref.txt; launches {launches}")
    return launches


def _write_genome(path: Path, codes, name: str) -> None:
    """One FASTA record of 2-bit ``codes`` in lines of 80."""
    import numpy as np

    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    full = len(text) // 80 * 80
    rows = np.concatenate([text[:full].reshape(-1, 80),
                           np.full((full // 80, 1), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as fh:
        fh.write(f">{name} synthetic genome\n".encode())
        fh.write(rows.tobytes())
        if full < len(text):
            fh.write(text[full:].tobytes() + b"\n")


def _write_reads(path: Path, rng, genome, n_reads: int, read_len: int, error: float) -> None:
    """FASTQ reads of ``genome`` (2-bit codes) at uniform positions, half of
    them reverse-complemented, each base substituted with rate ``error``."""
    import numpy as np

    starts = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    err = rng.random(reads.shape, dtype=np.float32) < error
    reads[err] = (reads[err] + rng.integers(1, 4, size=int(err.sum()), dtype=np.uint8)) % 4
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    text = np.frombuffer(b"ACGT", np.uint8)[reads]
    qual = b"I" * read_len
    with open(path, "wb") as fh:
        fh.write(b"".join(b"@r%d sim\n%s\n+\n%s\n" % (i, row.tobytes(), qual)
                          for i, row in enumerate(text)))


def _pool(seqs, p, dev, plain: bool = False):
    """Every k-mer hash of ``seqs`` as a host array: the byte stream the
    sketch routes build, hashed on the card in one launch of the unmasked
    kernel (K7/K8) or by its plain version, then downloaded.  It shares
    nothing with K5, K6, the thresholds, the chunk merge or ``screen``'s
    pool chunks and counting."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.models.sketch import _blob
    from fpmash_tpu_torch.ops import kmers_cuda

    stream = torch.from_numpy(_blob(seqs, p.kmer_size).copy()).to(dev)
    hashes = kmers_cuda.kmer_hashes_planes_plain if plain else kmers_cuda.kmer_hashes_planes
    lo, hi, valid = hashes(stream, k=p.kmer_size, seed=p.seed)
    pool = kmers_cuda.join_planes(lo, hi)[valid]
    if not p.use64:
        pool &= 0xFFFFFFFF
    return pool.cpu().numpy().view(np.uint64)


def _pool_oracle(seqs, p, dev, plain: bool = False):
    """``bottom_k_host`` of :func:`_pool`."""
    from fpmash_tpu_torch.ops.bottomk import bottom_k_host

    return bottom_k_host(_pool(seqs, p, dev, plain), p.sketch_size, p.min_cov)


def phase_classic_main_path(dev, rng, work: Path):
    """The classic workflow at E. coli scale through the CLI on cuda: three
    genomes of 5 000 000 bases (g2 is g1 with 5 % substitutions, g3
    independent) and 150-base reads at 10x of g1 with 1 % errors.
    ``sketch g1 g2 g3`` (K5), ``sketch -r -m 2 reads.fq`` (K5, collect-all),
    ``sketch -s 10000 g1`` (K6: below K5's gate), ``sketch -k 16 g1`` (K8,
    pool path), ``dist genomes.msh reads.msh`` (K9) and ``screen genomes.msh
    reads.fq`` (K7 over the whole read set, then its distinct counts), with
    the counts set to 0 just before and read just after.  Each sketch must
    equal :func:`_pool_oracle` of its input, each ``dist`` line the literal
    walk, and each ``screen`` line the one computed from ``np.unique`` of
    the K7 pool.  Returns the launches and the walls."""
    import io

    import numpy as np
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models.distance import compare_sketches
    from fpmash_tpu_torch.models.sketch import Sketch, SketchParams
    from fpmash_tpu_torch.ops.bottomk import bottom_k_host
    from fpmash_tpu_torch.utils import trace as trace_mod
    from fpmash_tpu_torch.utils.fasta import read_sequences
    from fpmash_tpu_torch.utils.msh import read_msh

    out = work / "classic"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    g1 = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    g2 = g1.copy()
    sub = rng.random(GENOME_LEN) < 0.05
    g2[sub] = (g2[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
    g3 = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    for i, g in enumerate((g1, g2, g3), 1):
        _write_genome(out / f"g{i}.fna", g, f"g{i}")
    n_reads = COVERAGE * GENOME_LEN // SHORT_READ
    _write_reads(out / "reads.fq", rng, g1, n_reads, SHORT_READ, 0.01)
    print(f"classic main path: 3 genomes of {GENOME_LEN} bases and {n_reads} reads of "
          f"{SHORT_READ} bases written in {time.perf_counter() - t0:.1f} s")

    genomes = [str(out / f"g{i}.fna") for i in (1, 2, 3)]
    commands = {
        "sketch g1 g2 g3": ["sketch", *genomes, "-o", str(out / "genomes")],
        "sketch -r -m 2 reads.fq": ["sketch", "-r", "-m", "2", str(out / "reads.fq"),
                                    "-o", str(out / "reads")],
        "sketch -s 10000 g1": ["sketch", "-s", "10000", genomes[0], "-o", str(out / "g1_s10000")],
        "sketch -k 16 g1": ["sketch", "-k", "16", genomes[0], "-o", str(out / "g1_k16")],
        "dist genomes.msh reads.msh": ["dist", str(out / "genomes.msh"), str(out / "reads.msh")],
        "screen genomes.msh reads.fq": ["screen", str(out / "genomes.msh"), str(out / "reads.fq")],
    }
    walls, spans, printed = {}, {}, {}
    trace_mod.enable(True)  # the stage spans go to stderr, captured below
    _reset_counts()
    for name, argv in commands.items():
        err, std = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(std):
            rc = main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        assert rc == 0, (name, rc, err.getvalue())
        spans[name] = [line[len("[fpmash] "):] for line in err.getvalue().splitlines()
                       if line.startswith("[fpmash] ")]
        printed[name] = std.getvalue()
    launches = _launches()
    trace_mod.enable(False)
    missing = [key for key in CLASSIC_PATH_KERNELS if launches[key] < 1]
    if missing:
        raise AssertionError(f"the classic main path did not launch {missing}: {launches}")

    t0 = time.perf_counter()

    def records(name):
        return [r.seq for r in read_sequences(str(out / name))]

    def check(path, want, what, counts=None):
        ref = read_msh(str(out / path)).references
        got = np.concatenate([h for h in (ref[0].hashes64, ref[0].hashes32) if h is not None])
        if not np.array_equal(got, want[0]):
            raise AssertionError(f"{what}: the sketch differs from bottom_k_host of the K7 pool")
        if counts and not np.array_equal(ref[0].counts32, want[1]):
            raise AssertionError(f"{what}: the counts differ from bottom_k_host of the K7 pool")

    for i in (1, 2, 3):
        ref = read_msh(str(out / "genomes.msh")).references[i - 1]
        if not np.array_equal(ref.hashes64, _pool_oracle(records(f"g{i}.fna"), SketchParams(),
                                                         dev)[0]):
            raise AssertionError(f"sketch g{i}.fna differs from bottom_k_host of the K7 pool")
    reads_pool = _pool(records("reads.fq"), SketchParams(), dev)
    check("reads.msh", bottom_k_host(reads_pool, 1000, 2), "sketch -r -m 2", counts=True)
    _check_screen(printed["screen genomes.msh reads.fq"], out / "genomes.msh", reads_pool)
    check("g1_s10000.msh", _pool_oracle(records("g1.fna"), SketchParams(sketch_size=10_000), dev),
          "sketch -s 10000")
    check("g1_k16.msh", _pool_oracle(records("g1.fna"), SketchParams(kmer_size=16), dev,
                                     plain=True), "sketch -k 16")

    lines = printed["dist genomes.msh reads.msh"].splitlines()
    ref, qry = Sketch(), Sketch()
    ref.load_msh(str(out / "genomes.msh"))
    qry.load_msh(str(out / "reads.msh"))
    p = ref.params
    if len(lines) != 3:
        raise AssertionError(f"dist printed {len(lines)} lines, not 3")
    dists = []
    for r, line in zip(ref.references, lines):
        rname, qname, d, pv, frac = line.split("\t")
        q = qry.references[0]
        res = compare_sketches(r.hashes, q.hashes, r.length, q.length, p.sketch_size,
                               p.kmer_size, p.kmer_space)
        if (rname, qname, frac) != (r.name, q.name, f"{res.numer}/{res.denom}"):
            raise AssertionError(f"dist line differs from the literal walk: {line}")
        if not (0.0 <= float(d) <= 1.0 and 0.0 <= float(pv) <= 1.0):
            raise AssertionError(f"dist line out of range: {line}")
        dists.append(float(d))
    if not dists[0] < dists[1] < dists[2]:
        raise AssertionError(f"reads of g1 should be nearest g1, then g2, then g3: {dists}")
    print(f"classic main path: every sketch equals bottom_k_host of the K7 (K8 plain for "
          f"-k 16) pool and every dist line the literal walk ({time.perf_counter() - t0:.1f} s)")

    for name in commands:
        print(f"classic main path: {name}: {walls[name]:.3f} s wall; spans: "
              + "; ".join(spans[name]))
    for line in lines:
        print(f"classic main path: dist: {line}")
    bases = 3 * GENOME_LEN + n_reads * SHORT_READ
    e2e = bases / sum(walls[n] for n in ("sketch g1 g2 g3", "sketch -r -m 2 reads.fq",
                                         "dist genomes.msh reads.msh"))
    print(f"classic main path: e2e (sketch g1 g2 g3, sketch -r -m 2, dist) {e2e:.1f} bases/s; "
          f"launches {launches}")
    return launches, walls


def _check_screen(text: str, genomes: Path, pool) -> None:
    """``screen``'s lines against an oracle that shares none of its
    counting: ``pool``, every k-mer hash of the reads (:func:`_pool`; reads
    are all longer than k), ``np.unique``d on the host, and each
    reference's shared hashes, median multiplicity and p-value from that."""
    import numpy as np

    from fpmash_tpu_torch.commands.screen_cmd import estimate_identity
    from fpmash_tpu_torch.models.sketch import Sketch
    from fpmash_tpu_torch.ops.bottomk import estimate_set_size
    from fpmash_tpu_torch.scalar.stats import format_g, screen_pvalue

    t0 = time.perf_counter()
    ref = Sketch()
    ref.load_msh(str(genomes))
    p = ref.params
    t1 = time.perf_counter()
    values, counts = np.unique(pool, return_counts=True)
    t_unique = time.perf_counter() - t1
    set_size = int(estimate_set_size(values, p.sketch_size, 64 if p.use64 else 32))
    want = []
    for r in ref.references:
        at = np.minimum(np.searchsorted(values, r.hashes), len(values) - 1)
        hit = values[at] == r.hashes
        shared, denom = int(hit.sum()), len(r.hashes)
        if shared:
            depth = np.sort(counts[at[hit]])
            identity = estimate_identity(shared, denom, p.kmer_size)
            pv = screen_pvalue(shared, set_size, p.kmer_space, denom)
            want.append(f"{format_g(identity)}\t{shared}/{denom}\t{int(depth[shared // 2])}\t"
                        f"{format_g(pv)}\t{r.name}\t{r.comment}")
    if text.splitlines() != want or not want:
        raise AssertionError(f"screen differs from np.unique of the K7 pool:\n{text}\n{want}")
    print(f"classic main path: screen equals the np.unique oracle of the K7 pool ({len(pool)} "
          f"hashes, {len(values)} distinct; {time.perf_counter() - t0:.1f} s, np.unique "
          f"{t_unique:.1f} s)")


def phase_kmer_main_shapes(dev, work: Path):
    """K5-K8 against their plain versions at the main path's shape, one
    chunk of 16 Mi positions: g1.fna as the direct route ships it, with the
    thresholds of s = 1000 (K5) and s = 10 000 (K6); K7 at k = 21 and K8 at
    k = 16 over the same bytes.  Returns each kernel's error and times."""
    import torch

    from fpmash_tpu_torch.models import sketch as port_sketch
    from fpmash_tpu_torch.ops import kmers_cuda as kc
    from fpmash_tpu_torch.ops.kmers import chunk_threshold
    from fpmash_tpu_torch.utils.fasta import read_sequences

    seqs = [r.seq for r in read_sequences(str(work / "classic" / "g1.fna"))]
    seq, length = port_sketch._direct_chunk(port_sketch._blob(seqs, 21), 0, dev)
    N = seq.numel()
    cases = {
        "k7": (kc.kmer_hashes_planes, kc.kmer_hashes_planes_plain, (), 21),
        "k8": (kc.kmer_hashes_planes, kc.kmer_hashes_planes_plain, (), 16),
        "k6": (kc.kmer_hashes_masked_planes, kc.kmer_hashes_masked_planes_plain,
               (chunk_threshold(N, 21, 10_000)[0], length), 21),
        "k5": (kc.kmer_hashes_topk8_planes, kc.kmer_hashes_topk8_planes_plain,
               (chunk_threshold(N, 21, 1000)[0], length), 21),
    }
    out = {}
    for name, (kernel, plain, cut, k) in cases.items():
        got = kernel(seq, *cut, k=k)
        want = plain(seq, *cut, k=k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version on g1's chunk")
        out[name] = {
            "max_abs_err": _max_abs_err(zip(got, want)),
            "ms": _time_ms(lambda f=kernel, c=cut, k=k: f(seq, *c, k=k), 20),
            "plain_ms": _time_ms(lambda f=plain, c=cut, k=k: f(seq, *c, k=k), 3),
            # the chunk in, the planes out; per position about 10 operations
            # for the codes, the rolling forward and reverse-complement words
            # and the canonical pick, then MurmurHash3 of the k bytes
            **_bound(N + sum(g.numel() * g.element_size() for g in got),
                     N * (10 + MURMUR_WORD_OPS * -(-k // 8) + MURMUR_FINAL_OPS)),
        }
        if name == "k5" and bool(got[2]):
            raise AssertionError("K5 overflowed a group on g1's chunk")
    print(f"main-path shapes: one chunk of {N} positions ({length} bases of g1.fna), all equal "
          "to the plain versions; "
          + "; ".join(f"{name.upper()} kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms"
                      for name, t in out.items()))
    return out["k5"], out["k6"], out["k7"], out["k8"]


# ---------------------------------------------------------------------- #
# the sorted all-pairs comparison: K9, and BASELINE config 4
# ---------------------------------------------------------------------- #

U64MAX = 0xFFFFFFFFFFFFFFFF
#: merged elements K9's warp takes a step (kW = 32 x kE in csrc/compare.cu)
K9_STEP = 512


def _k9_cases(rng):
    """Sorted lists for K9: (name, ref, ref_len, qry, qry_len, caps)."""
    import numpy as np

    def pick(pool, n, width):
        return np.stack([np.sort(pool[rng.choice(len(pool), width, replace=False)])
                         for _ in range(n)])

    # even hashes from a shared pool; odd ones are fresh, so disjoint
    pool = np.unique(rng.integers(0, U64MAX, size=8000, dtype=np.uint64) & np.uint64(U64MAX - 1))
    fresh = np.unique(rng.integers(0, U64MAX, size=4000, dtype=np.uint64) | np.uint64(1))
    ref, qry = pick(pool, 37, 1200), pick(pool, 53, 1200)
    qry[0] = ref[0]  # identical
    qry[1] = fresh[:1200]  # disjoint
    qry[2] = np.sort(np.concatenate([ref[3][:1080], fresh[1200:1320]]))  # 90 % shared
    rl, ql = np.full(37, 1200, np.int32), np.full(53, 1200, np.int32)
    rl[5:11] = [0, 1, 63, 64, 999, 1001]
    ql[5:11] = [1001, 0, 1, 65, 1000, 1200]
    cases = [("distinct 37x53 of 1200", ref, rl, qry, ql, (64, 1000, 10_000))]

    # rows wider than the 4 096 hashes staged in shared memory
    wide = np.unique(rng.integers(0, U64MAX, size=30_000, dtype=np.uint64))
    ref, qry = pick(wide, 5, 6000), pick(wide, 11, 6000)
    qry[0] = ref[0]
    rl, ql = np.full(5, 6000, np.int32), np.full(11, 6000, np.int32)
    rl[1], ql[1:4] = 4097, [4096, 0, 5000]
    cases.append(("wide 5x11 of 6000", ref, rl, qry, ql, (1000, 10_000)))

    # sorted rows with repeats, some with the high bit, some ending in a real 2^64 - 1
    small = np.concatenate([rng.integers(0, 1 << 20, 150, dtype=np.uint64),
                            rng.integers(1 << 63, U64MAX, 50, dtype=np.uint64)])
    ref = np.sort(small[rng.integers(0, 200, (29, 300))], axis=1)
    qry = np.sort(small[rng.integers(0, 200, (41, 300))], axis=1)
    ref[::4, -3:] = U64MAX
    qry[1::3, -1:] = U64MAX
    rl = rng.integers(0, 301, 29).astype(np.int32)
    ql = rng.integers(0, 301, 41).astype(np.int32)
    rl[:3], ql[:3] = [0, 1, 300], [300, 0, 300]
    cases.append(("repeats 29x41 of 300", ref, rl, qry, ql, (1, 64, 1000)))

    # the edges of K9's step of K9_STEP merged elements: caps one below, at
    # and one above it, lengths off its multiples, empty lists, Q = 100 (two
    # query groups of 50)
    ref, qry = pick(pool, 23, 1200), pick(pool, 100, 1200)
    qry[0], qry[1] = ref[0], np.sort(np.concatenate([ref[1][:600], fresh[:600]]))
    rl = rng.integers(0, 1201, 23).astype(np.int32)
    ql = rng.integers(0, 1201, 100).astype(np.int32)
    s = K9_STEP
    rl[:8] = [1200, 1200, 0, s - 1, s, s + 1, 2 * s + 7, 1]
    ql[:8] = [1200, 1200, s + 1, 0, s - 1, s, 3 * s - 5, 1199]
    caps = (s - 1, s, s + 1, 2 * s - 1)
    cases.append(("step edges 23x100 of 1200", ref, rl, qry, ql, caps))
    # drawn with replacement from 1 500 values, so the union passes the caps
    wide_small = np.concatenate([rng.integers(0, 1 << 40, 1200, dtype=np.uint64),
                                 rng.integers(1 << 63, U64MAX, 300, dtype=np.uint64)])
    ref = np.sort(wide_small[rng.integers(0, 1500, (13, 1100))], axis=1)
    qry = np.sort(wide_small[rng.integers(0, 1500, (100, 1100))], axis=1)
    qry[5::7, -2:] = U64MAX
    rl = rng.integers(0, 1101, 13).astype(np.int32)
    ql = rng.integers(0, 1101, 100).astype(np.int32)
    rl[:4], ql[:4] = [0, s - 1, s, s + 1], [s + 1, 0, s, 1100]
    cases.append(("step edges, repeats 13x100 of 1100", ref, rl, qry, ql, caps))
    return cases


def phase_k9(dev, rng):
    """K9 against its plain version, exactly, on sorted lists: identical,
    disjoint and 90 %-shared pairs; lengths 0, 1, below and above the cap;
    caps 64, 1 000 and 10 000; rows wider than the shared-memory stage;
    rows with repeats and a real 2^64 - 1 hash; R and Q not multiples of 8;
    at the edges of the kernel's step (caps and lengths one below, at and
    one above ``K9_STEP``, Q = 100), distinct and with repeats.  Returns the
    largest error."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops import compare_cuda

    err, checked = 0.0, []
    for name, ref, rl, qry, ql, caps in _k9_cases(rng):
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (ref.view(np.int64), rl, qry.view(np.int64), ql))
        for cap in caps:
            got = compare_cuda.pairwise_common_denom(*args, cap)
            want = compare_cuda.pairwise_common_denom_plain(*args, cap)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("common", "denom")):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(f"K9 {what} differs from the plain version in {bad} "
                                         f"pairs ({name}, cap {cap})")
            if int(got[0].sum()) == 0:
                raise AssertionError(f"K9 test lists share nothing ({name}); the check is vacuous")
            err = max(err, _max_abs_err(zip(got, want)))
            checked.append(f"{name} cap {cap}")
    print(f"K9 compare: equal to the plain version on {len(checked)} sets: " + "; ".join(checked))
    return err


#: BASELINE config 4: all-pairs distance over N_ALL classic sketches (k = 21,
#: s = 1000) in N_CLUSTERS clusters of related genomes, each cluster's
#: members drawn from a base set of BASE_SET hashes
N_ALL, N_CLUSTERS, BASE_SET, SKETCH = 10_000, 100, 3_000, 1000
#: the config-4 CLI runs: dist over N_ALL x N_QRY pairs, triangle over N_TRI
N_QRY, N_TRI = 100, 1000


def _cluster_lists(rng, dev, n: int, width: int, keep: int, sort: bool):
    """``n`` hash lists in ``N_CLUSTERS`` interleaved clusters (member ``i``
    in cluster ``i % N_CLUSTERS``).  Each cluster draws ``width`` random
    hashes; each member replaces a fraction ``m ~ U(0, 1)`` of them with
    fresh ones (``m = 0`` for the first member of each cluster), so two
    members share about ``(1 - m1)(1 - m2)`` of their hashes and members of
    two clusters almost none.  Sorted: the ``keep`` smallest, ascending (a
    MinHash sketch); else the first ``keep`` in place (a fingerprint, 32-bit)."""
    import numpy as np
    import torch

    from fpmash_tpu_torch.ops.murmur3 import _SIGN

    top = U64MAX if sort else 0xFFFFFFFF  # exclusive: no list holds the pad
    base = rng.integers(0, top, size=(N_CLUSTERS, width), dtype=np.uint64)
    members = base[np.arange(n) % N_CLUSTERS]
    rate = rng.random(n)
    rate[:N_CLUSTERS] = 0.0
    swap = rng.random((n, width), dtype=np.float32) < rate[:, None]
    members[swap] = rng.integers(0, top, size=int(swap.sum()), dtype=np.uint64)
    if not sort:
        return list(members[:, :keep])
    x = torch.from_numpy(members.view(np.int64)).to(dev) ^ _SIGN
    x = torch.sort(x, dim=1).values[:, :keep]
    if not bool((x[:, 1:] > x[:, :-1]).all()):
        raise AssertionError("a generated sketch repeats a hash")
    return list((x ^ _SIGN).cpu().numpy().view(np.uint64))


def _write_sketch(path: Path, lists, params: dict, length: int) -> None:
    from fpmash_tpu_torch.models.sketch import sketch_from_arrays

    refs = [dict(name=f"s{i}", comment=f"cluster {i % N_CLUSTERS}", length=length, hashes=h)
            for i, h in enumerate(lists)]
    sketch_from_arrays(params, refs).write_msh(str(path))


def phase_config4(dev, rng, work: Path):
    """BASELINE config 4 on one card: all-pairs distance over 10 000 classic
    sketches (k = 21, s = 1000).  With the counts set to 0 just before and
    read just after: ``models/distance.all_pairs_common_denom`` over all 10^8
    pairs (K9), and through the CLI ``dist refs.msh qrys.msh`` (10 000 x 100
    sketches), ``triangle`` over 1 000 of them and ``triangle -fp`` over
    1 000 fingerprint sketches (positional).  Then every one of the 10^8
    pairs against K2's walk on the card (equal to the literal walk on
    sorted distinct lists), and samples of the CLI lines against the
    literal walk and ``compare_fingerprints``.  Returns the launches, K9's
    record at this shape, K2's times and bound at the 10^8 pairs, the walls,
    and the phase's data for :func:`phase_multi_device`: the sketches' lists
    (``refs``, ``qrys``, ``fp``) and the all-pairs ``common`` and ``denom``."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models import distance
    from fpmash_tpu_torch.models.distance import compare_fingerprints, compare_sketches
    from fpmash_tpu_torch.models.sketch import Sketch, SketchParams
    from fpmash_tpu_torch.ops import compare_cuda, walk_cuda
    from fpmash_tpu_torch.ops.walk import pad_lists
    from fpmash_tpu_torch.scalar.stats import format_g

    out = work / "config4"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    lists = _cluster_lists(rng, dev, N_ALL + N_QRY, BASE_SET, SKETCH, sort=True)
    refs = lists[:N_ALL]
    classic = dict(kmer_size=21, sketch_size=SKETCH)
    _write_sketch(out / "refs.msh", refs, classic, 5_000_000)
    _write_sketch(out / "qrys.msh", lists[N_ALL:], classic, 5_000_000)
    _write_sketch(out / "tri.msh", refs[:N_TRI], classic, 5_000_000)
    fp_lists = [h[: int(n)] for h, n in zip(
        _cluster_lists(rng, dev, N_TRI, SKETCH, SKETCH, sort=False),
        rng.integers(SKETCH // 2, SKETCH + 1, N_TRI))]
    _write_sketch(out / "fp.msh", fp_lists, dataclasses.asdict(SketchParams().for_fingerprint()),
                  SKETCH)
    print(f"config 4: {N_ALL + N_QRY} sketches of {SKETCH} in {N_CLUSTERS} clusters and "
          f"{N_TRI} fingerprint sketches made and written in {time.perf_counter() - t0:.1f} s")

    commands = {
        "dist refs.msh qrys.msh": ["dist", str(out / "refs.msh"), str(out / "qrys.msh")],
        "triangle tri.msh": ["triangle", str(out / "tri.msh")],
        "triangle -fp fp.msh": ["triangle", "-fp", str(out / "fp.msh")],
    }
    walls = {}
    _reset_counts()
    t0 = time.perf_counter()
    common, denom = distance.all_pairs_common_denom(refs, refs, SKETCH, devices=(dev,))
    walls["all_pairs_common_denom"] = time.perf_counter() - t0
    for name, argv in commands.items():
        t0 = time.perf_counter()
        with open(out / f"{argv[0]}{'-fp' if '-fp' in argv else ''}.txt", "w") as fh, \
                contextlib.redirect_stdout(fh), contextlib.redirect_stderr(io.StringIO()):
            rc = main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        assert rc == 0, (name, rc)
    launches = _launches()
    if launches["compare"] < 3:
        raise AssertionError(f"config 4 did not launch K9 in all-pairs, dist and triangle: "
                             f"{launches}")

    t0 = time.perf_counter()
    walk_c, walk_d = distance.all_pairs_walk(refs, refs, SKETCH, devices=(dev,))
    if not (np.array_equal(common, walk_c) and np.array_equal(denom, walk_d)):
        bad = int(((common != walk_c) | (denom != walk_d)).sum())
        raise AssertionError(f"K9 differs from K2's walk in {bad} of the {N_ALL ** 2} pairs")
    shared = common / np.maximum(denom, 1)
    spread = np.histogram(shared, bins=[0, 1e-9, 0.25, 0.5, 0.75, 1.0 - 1e-9, 1.0 + 1e-9])[0]

    lines = (out / "dist.txt").read_text().splitlines()
    qry = Sketch()
    qry.load_msh(str(out / "qrys.msh"))
    if len(lines) != N_ALL * N_QRY:
        raise AssertionError(f"dist printed {len(lines)} lines, not {N_ALL * N_QRY}")
    for li in rng.choice(len(lines), 64, replace=False):
        qi, ri = divmod(int(li), N_ALL)
        r, q = refs[ri], qry.references[qi]
        res = compare_sketches(r, q.hashes, 5_000_000, q.length, SKETCH, 21, 4.0**21)
        want = f"s{ri}\t{q.name}\t{format_g(res.distance)}\t{format_g(res.pvalue)}\t" \
               f"{res.numer}/{res.denom}"
        if lines[li] != want:
            raise AssertionError(f"dist line {li} differs from the literal walk: {lines[li]}")
    for name, file, cmp in (("triangle", "triangle.txt", "walk"),
                            ("triangle -fp", "triangle-fp.txt", "positional")):
        rows = (out / file).read_text().splitlines()
        if len(rows) != N_TRI + 1 or rows[0] != f"\t{N_TRI}":
            raise AssertionError(f"{name} printed {len(rows)} rows")
        for i in rng.integers(1, N_TRI, 32):
            j = int(rng.integers(0, i))
            cells = rows[i + 1].split("\t")
            if cmp == "walk":
                res = compare_sketches(refs[i], refs[j], 1, 1, SKETCH, 21, 4.0**21)
            else:
                res = compare_fingerprints(fp_lists[i], fp_lists[j])
            if len(cells) != i + 1 or cells[j + 1] != format_g(res.distance):
                raise AssertionError(f"{name} row {i} column {j} differs from the literal "
                                     f"comparison: {cells[j + 1]} vs {res.distance}")
    print(f"config 4: K9 equals K2's walk on all {N_ALL ** 2} pairs; shared fraction 0 / (0, "
          f"1/4) / [1/4, 1/2) / [1/2, 3/4) / [3/4, 1) / 1: {spread.tolist()}; dist, triangle and "
          f"triangle -fp lines equal the literal comparisons ({time.perf_counter() - t0:.1f} s)")

    # K9 against its plain version, exactly, at every shape the main path
    # launched it at: 32 rows of each all-pairs launch ([rows, N_ALL] x
    # [N_ALL], read from the main path's own output), and dist's [N_ALL] x
    # [N_QRY] and triangle's [N_TRI] x [N_TRI] launched anew
    t0 = time.perf_counter()
    ref, ref_len = pad_lists(refs, dev)
    qry, qry_len = pad_lists(lists[N_ALL:], dev)
    rows = distance._TILE_PAIRS // N_ALL
    pick = np.sort(np.concatenate([rng.choice(rows, 32, replace=False),
                                   rows + rng.choice(N_ALL - rows, 32, replace=False)]))
    sel = torch.from_numpy(pick).to(dev)
    want = compare_cuda.pairwise_common_denom_plain(ref[sel], ref_len[sel], ref, ref_len, SKETCH)
    got = (torch.from_numpy(common[pick]), torch.from_numpy(denom[pick]))
    want = tuple(w.cpu() for w in want)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K9 differs from the plain version in rows {pick.tolist()} of "
                             f"the all-pairs launches")
    err = _max_abs_err(zip(got, want))
    dist_args = (ref, ref_len, qry, qry_len, SKETCH)
    tri_args = (ref[:N_TRI], ref_len[:N_TRI], ref[:N_TRI], ref_len[:N_TRI], SKETCH)
    for name, a in (("dist", dist_args), ("triangle", tri_args)):
        got = compare_cuda.pairwise_common_denom(*a)
        want = compare_cuda.pairwise_common_denom_plain(*a)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K9 differs from the plain version at {name}'s shape "
                                 f"{a[0].shape[0]} x {a[2].shape[0]}")
        err = max(err, _max_abs_err(zip(got, want)))
        if name == "dist":
            dist_common, dist_denom = got
    print(f"config 4: K9 equals its plain version on {len(pick)} x {N_ALL} pairs of the "
          f"all-pairs launches, at dist's {N_ALL} x {N_QRY} and at triangle's {N_TRI} x "
          f"{N_TRI} ({time.perf_counter() - t0:.1f} s)")

    def union_ops(c, d):
        # every element of the union up to the cap: a 64-bit compare and an
        # equality test, about 4 32-bit operations
        return 4 * (int(d.sum(dtype=torch.int64)) + int(c.sum(dtype=torch.int64)))

    # the record is at dist's shape, where the plain version runs in a
    # fraction of a second; the 10^8-pair time and bound go beside it
    args = (ref, ref_len, ref, ref_len, SKETCH)
    k9 = {
        "max_abs_err": err,
        "ms": _time_ms(lambda: compare_cuda.pairwise_common_denom(*dist_args), 20),
        "plain_ms": _time_ms(lambda: compare_cuda.pairwise_common_denom_plain(*dist_args), 1),
        **_bound(_lists_bytes(ref, qry), union_ops(dist_common, dist_denom)),
        "pairs": N_ALL * N_QRY,
        "all_pairs_ms": _time_ms(lambda: compare_cuda.pairwise_common_denom(*args), 2),
        "all_pairs_bound_ms": _bound(_lists_bytes(ref, ref),
                                     union_ops(torch.from_numpy(common),
                                               torch.from_numpy(denom)))["bound_ms"],
        "all_pairs": N_ALL ** 2,
    }
    k2 = {
        "all_pairs_ms": _time_ms(lambda: walk_cuda.pairwise_walk(*args), 2),
        "all_pairs_launch_ms": _time_ms(_walk_launch(*args), 2),
        "all_pairs_bound_ms": _bound(_lists_bytes(ref, ref),
                                     _walk_ops(ref_len, ref_len, SKETCH))["bound_ms"],
        "all_pairs": N_ALL ** 2,
    }
    for name, wall in walls.items():
        print(f"config 4: {name}: {wall:.3f} s wall")
    print(f"config 4: K9 at dist's {N_ALL}x{N_QRY} pairs {k9['ms']:.4f} ms, plain version "
          f"{k9['plain_ms']:.4f} ms, bound {k9['bound_ms']:.4f} ms ({k9['bound_by']}); K9 at "
          f"{N_ALL}x{N_ALL} pairs {k9['all_pairs_ms']:.4f} ms "
          f"({N_ALL ** 2 / k9['all_pairs_ms'] * 1e3:.4g} pairs/s), bound "
          f"{k9['all_pairs_bound_ms']:.4f} ms; K2 at the same pairs {k2['all_pairs_ms']:.4f} ms "
          f"({k2['all_pairs_launch_ms']:.4f} ms through the C entry point), bound "
          f"{k2['all_pairs_bound_ms']:.4f} ms; launches {launches}")
    data = dict(refs=refs, qrys=lists[N_ALL:], fp=fp_lists, common=common, denom=denom)
    return launches, k9, k2, walls, data


# ---------------------------------------------------------------------- #
# the multi-device layer: the sharded routes on a mesh of 4 shards, byte for
# byte against one device
# ---------------------------------------------------------------------- #

#: BASELINE config 5: reads of the classic phase's g1, sketched sharded
CONFIG5_READS, CONFIG5_READ_LEN = 1_000_000, 150
#: shards of the phase's mesh; reads of config 5 in the CLI check's FASTQ
N_SHARDS, CLI_READS = 4, 100_000


def _shard_mesh():
    """The phase's mesh: shard ``i`` on card ``i % min(4, count)``, so 4
    shards on cuda:0 on a machine with one card; and how it is laid out."""
    import torch

    cards = min(N_SHARDS, torch.cuda.device_count())
    mesh = tuple(torch.device("cuda", i % cards) for i in range(N_SHARDS))
    if cards == 1:
        return mesh, (f"{N_SHARDS} shards on cuda:0 (one card: the shards share its stream "
                      "and run one after another; not a scaling result)")
    return mesh, f"{N_SHARDS} shards on cards {list(range(cards))} (shard i on card i % {cards})"


def _check_same(what: str, got, want) -> None:
    """Raise unless each array (numpy, or a tensor) of ``got`` equals the
    one of ``want`` exactly."""
    import numpy as np

    for g, w in zip(got, want):
        g, w = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x) for x in (g, w))
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{what}: the sharded result differs from one device's")


def phase_multi_device(dev, rng, work: Path, config4: dict, seqs_a):
    """The multi-device layer (``fpmash_tpu_torch/parallel/``) on an explicit
    mesh of 4 shards (:func:`_shard_mesh`), every result held byte for byte
    against the one-device run of the same call, with the counts set to 0
    just before and the phase's launches printed:

    1. BASELINE config 5: 1 000 000 reads of 150 bases of the classic
       phase's g1 (1 % substitutions, half reverse-complemented, FASTQ),
       ``sketch -r -m 2`` (the collect-all route) and ``sketch -r`` (the
       direct route), each on 1 and on 4 shards, with the wall, the chunks
       each shard and card took and the peak memory of each card; then
       ``dist`` of the sketch against the classic phase's three genomes;
    2. both FASTAs of the CFL (K1) and ICFL_COMB (K3, K4) main paths,
       sharded, against the ``.msh`` files their CLI runs wrote;
    3. config 4: K9 over all 10^8 pairs against the result ``phase_config4``
       computed, ``dist``'s 10 000 x 100, ``triangle`` and ``triangle -fp``
       over 1 000;
    4. ``dist -fp`` of the CFL path's 256 x 256 sketches through
       ``sharded_all_pairs_walk`` (K2) and through the route;
    5. ``pipeline_step`` on the CFL path's 512 000 windows (s = 1000)
       against config 4's 10 000 sketches, whose sketch must also be the
       1000 smallest distinct K1 hashes;
    6. the CLI (``sketch --direct-fp``, ``sketch -r -m 2``, ``dist``,
       ``triangle``) under ``FPMASH_DEVICES`` set to the card count and to 1.
    """
    import io
    import os

    import numpy as np
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models import sketch as sketch_mod
    from fpmash_tpu_torch.models.distance import (
        all_pairs_common_denom,
        all_pairs_dist,
        all_pairs_positional,
        common_denom,
    )
    from fpmash_tpu_torch.models.fingerprint import extract_reads
    from fpmash_tpu_torch.models.sketch import Sketch, SketchParams
    from fpmash_tpu_torch.ops import fused_cuda, walk_cuda
    from fpmash_tpu_torch.ops.walk import pad_lists
    from fpmash_tpu_torch.parallel import sharded
    from fpmash_tpu_torch.utils.fasta import read_sequences

    t_phase = time.perf_counter()
    mesh, layout = _shard_mesh()
    print(f"multi-device: mesh {[str(d) for d in mesh]}: {layout}")
    out = work / "config5"
    out.mkdir(parents=True, exist_ok=True)
    _reset_counts()

    # 1. config 5
    t0 = time.perf_counter()
    code = np.zeros(256, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    g1 = next(read_sequences(str(work / "classic" / "g1.fna"))).seq
    _write_reads(out / "reads.fq", rng, code[np.frombuffer(g1.encode(), np.uint8)],
                 CONFIG5_READS, CONFIG5_READ_LEN, 0.01)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = list(read_sequences(str(out / "reads.fq")))
    print(f"multi-device: config 5: {len(records)} reads of {CONFIG5_READ_LEN} bases of g1 "
          f"written in {written:.1f} s, parsed in {time.perf_counter() - t0:.1f} s")
    k = 21
    n = len(records) * (CONFIG5_READ_LEN + k - 1) - (k - 1)
    n_chunks = sum(1 for pos in range(0, n, sketch_mod._DIRECT_CHUNK - (k - 1))
                   if min(pos + sketch_mod._DIRECT_CHUNK, n) - pos >= k)
    sketches = {}
    for mode, tag, params in (
            ("sketch -r -m 2", "reads_m2", SketchParams(reads=True, counts=True, min_cov=2)),
            ("sketch -r", "reads", SketchParams(reads=True, counts=True))):
        for shards, m in ((1, (dev,)), (N_SHARDS, mesh)):
            devices = sorted(set(m), key=str)
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
            before = _launches()
            t0 = time.perf_counter()
            sk = Sketch(params)
            sk.init_from_sequences(records, name=str(out / "reads.fq"), merge=True, devices=m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path = out / f"{tag}_{shards}.msh"
            sk.write_msh(str(path))
            sketches[mode, shards] = path
            after = _launches()
            chunk_launches = sum(after[key] - before[key] for key in ("kmer:topk8", "kmer:masked"))
            per_shard = [len(range(i, n_chunks, shards)) for i in range(shards)]
            per_card = {str(d): sum(c for c, x in zip(per_shard, m) if x == d) for d in devices}
            peaks = {str(d): round(torch.cuda.max_memory_allocated(d) / 2**30, 3)
                     for d in devices}
            print(f"multi-device: config 5 {mode}, {shards} shard(s): {wall:.3f} s wall "
                  f"({len(records) * CONFIG5_READ_LEN / wall:.4g} bases/s); {n_chunks} chunks "
                  f"of {sketch_mod._DIRECT_CHUNK} bases, per shard {per_shard}, per card "
                  f"{per_card}; K5/K6 launches {chunk_launches}; peak memory GiB {peaks}")
        if sketches[mode, 1].read_bytes() != sketches[mode, N_SHARDS].read_bytes():
            raise AssertionError(f"config 5 {mode}: the sharded .msh differs from one device's")
    del records
    genomes, reads = Sketch(), Sketch()
    genomes.load_msh(str(work / "classic" / "genomes.msh"))
    reads.load_msh(str(sketches["sketch -r -m 2", N_SHARDS]))
    lists = ([r.hashes for r in genomes.references], [r.hashes for r in reads.references])
    _check_same("config 5 dist", common_denom(*lists, 1000, devices=mesh),
                common_denom(*lists, 1000, devices=(dev,)))
    dists = [res.distance for _, _, res in all_pairs_dist(genomes, reads, devices=mesh)]
    if not dists[0] < dists[1] < dists[2]:
        raise AssertionError(f"config 5 reads of g1 should be nearest g1, then g2, g3: {dists}")
    print(f"multi-device: config 5: both sketches byte-identical on 1 and {N_SHARDS} shards; "
          f"dist genomes.msh reads.msh (one query, so one shard) {dists}")

    # 2. the fingerprint main paths' FASTAs
    t0 = time.perf_counter()
    for family in ("CFL", "ICFL_COMB"):
        for tag in ("a", "b"):
            before = _launches()
            sk = Sketch(SketchParams().for_fingerprint())
            sk.init_from_reads_fingerprint(extract_reads(str(work / family / f"{tag}.fasta"),
                                                         rev_com=True),
                                           family, devices=mesh)
            path = work / family / f"{tag}_sharded.msh"
            sk.write_msh(str(path))
            if path.read_bytes() != (work / family / f"{tag}.msh").read_bytes():
                raise AssertionError(f"{family} {tag}.fasta: the sharded .msh differs from the "
                                     "one-device CLI's")
            after = _launches()
            launched = {key: after[key] - before[key] for key in MAIN_PATH_KERNELS[family]
                        if key != "walk"}
            if set(launched.values()) != {N_SHARDS}:
                raise AssertionError(f"{family} {tag}.fasta: not one launch a shard: {launched}")
    print(f"multi-device: sketch --direct-fp of the CFL and ICFL_COMB paths' a.fasta and b.fasta "
          f"({N_READS * READ_LEN} windows each) on {N_SHARDS} shards byte-identical to the CLI's "
          f"one-device .msh, one launch of each kernel a shard ({time.perf_counter() - t0:.1f} s)")

    # 3. config 4
    t0 = time.perf_counter()
    got = all_pairs_common_denom(config4["refs"], config4["refs"], SKETCH, devices=mesh)
    wall = time.perf_counter() - t0
    _check_same("config 4 all pairs", got, (config4["common"], config4["denom"]))
    del got
    refs, tri = config4["refs"], config4["refs"][:N_TRI]
    _check_same("config 4 dist", common_denom(refs, config4["qrys"], SKETCH, devices=mesh),
                common_denom(refs, config4["qrys"], SKETCH, devices=(dev,)))
    _check_same("config 4 triangle", common_denom(tri, tri, SKETCH, devices=mesh),
                common_denom(tri, tri, SKETCH, devices=(dev,)))
    _check_same("config 4 triangle -fp",
                all_pairs_positional(config4["fp"], devices=mesh),
                all_pairs_positional(config4["fp"], devices=(dev,)))
    print(f"multi-device: config 4: K9 over all {N_ALL ** 2} pairs on {N_SHARDS} shards equals "
          f"phase_config4's result ({wall:.3f} s wall); dist {N_ALL} x {N_QRY}, triangle and "
          f"triangle -fp over {N_TRI} equal one device's")

    # 4. dist -fp of the CFL path through sharded_all_pairs_walk
    a, b = Sketch(), Sketch()
    a.load_msh(str(work / "CFL" / "a.msh"))
    b.load_msh(str(work / "CFL" / "b.msh"))
    s = min(a.params.sketch_size, b.params.sketch_size)
    lists = ([r.hashes for r in a.references], [r.hashes for r in b.references])
    args = (*pad_lists(lists[0], dev), *pad_lists(lists[1], dev), s)
    before = walk_cuda.LAUNCHES
    got = sharded.sharded_all_pairs_walk(mesh, *args)
    if walk_cuda.LAUNCHES - before != N_SHARDS:
        raise AssertionError("sharded_all_pairs_walk did not launch K2 once a shard")
    _check_same("dist -fp (sharded_all_pairs_walk)", got, walk_cuda.pairwise_walk(*args))
    _check_same("dist -fp (route)", common_denom(*lists, s, devices=mesh),
                common_denom(*lists, s, devices=(dev,)))
    print(f"multi-device: dist -fp a.msh b.msh ({len(lists[0])} x {len(lists[1])}) through "
          f"sharded_all_pairs_walk and the route on {N_SHARDS} shards equals one device's")

    # 5. pipeline_step
    flat, starts, lengths = _main_stream(dev, seqs_a)
    rows = flat[starts[:, None] + torch.arange(WINDOW, device=dev)].contiguous()
    ref, ref_len = pad_lists(refs, dev)
    walls = {}
    for shards, m in ((N_SHARDS, mesh), (1, (dev,))):
        t0 = time.perf_counter()
        step = sharded.pipeline_step(m, rows, lengths, ref, ref_len, seed=42, sketch_size=SKETCH)
        torch.cuda.synchronize()
        walls[shards] = time.perf_counter() - t0
        if shards == N_SHARDS:
            got = step
    _check_same("pipeline_step", got, step)
    h1 = fused_cuda.fingerprint_hashes(flat, starts, lengths, 42)[0].cpu().numpy().view(np.uint64)
    if not np.array_equal(got[0].cpu().numpy().view(np.uint64), np.unique(h1)[:SKETCH]):
        raise AssertionError("pipeline_step's sketch is not the 1000 smallest distinct K1 hashes")
    print(f"multi-device: pipeline_step ({rows.shape[0]} windows, s = {SKETCH}, {len(refs)} "
          f"reference sketches): {N_SHARDS} shards {walls[N_SHARDS]:.3f} s, one device "
          f"{walls[1]:.3f} s, equal; its sketch is the {SKETCH} smallest distinct K1 hashes; "
          f"most hashes shared with a reference {int(got[1].max())}")
    del rows, ref, ref_len, got, step

    # 6. the CLI under FPMASH_DEVICES
    count = torch.cuda.device_count()
    with open(out / "reads.fq", "rb") as src, open(out / "cli.fq", "wb") as dst:
        for _, line in zip(range(4 * CLI_READS), src):
            dst.write(line)
    commands = {
        "sketch --direct-fp": ["sketch", "--direct-fp", str(work / "CFL" / "a.fasta")],
        "sketch -r -m 2": ["sketch", "-r", "-m", "2", str(out / "cli.fq")],
        "dist": ["dist", str(work / "classic" / "genomes.msh"),
                 str(sketches["sketch -r -m 2", 1])],
        "triangle": ["triangle", str(work / "classic" / "genomes.msh")],
    }
    outputs = {}
    saved = os.environ.get("FPMASH_DEVICES")
    try:
        for n in (count, 1):
            os.environ["FPMASH_DEVICES"] = str(n)
            for name, argv in commands.items():
                std = io.StringIO()
                prefix = ["-o", str(out / f"cli_{len(outputs)}")]
                with contextlib.redirect_stdout(std), contextlib.redirect_stderr(io.StringIO()):
                    rc = main([*argv, *(prefix if argv[0] == "sketch" else [])])
                assert rc == 0, (name, rc)
                outputs[name, n] = (std.getvalue() if argv[0] != "sketch"
                                    else Path(prefix[1] + ".msh").read_bytes())
    finally:
        if saved is None:
            os.environ.pop("FPMASH_DEVICES", None)
        else:
            os.environ["FPMASH_DEVICES"] = saved
    for name in commands:
        if outputs[name, count] != outputs[name, 1]:
            raise AssertionError(f"{name}: FPMASH_DEVICES={count} and =1 differ")
    where = ("one card: both take the one-device path, so this checks the plumbing, not a "
             "multi-card result" if count == 1 else f"{count} cards against one")
    print(f"multi-device: CLI {list(commands)} byte-identical under FPMASH_DEVICES={count} and "
          f"=1 ({where})")
    print(f"multi-device: launches in the phase {_launches()}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# the JAX package's unrouted kernels, through their own entry points at the
# main paths' shapes: K13 on the CFL path's windows; K10, K11, K12 and K15
# on the classic path's chunk
# ---------------------------------------------------------------------- #


def _same(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def _check_equal(what: str, got, want, upto: int | None = None) -> None:
    """Raise unless each output of ``got`` equals the one of ``want``
    exactly (only positions below ``upto``, when given)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not (_same(g, w) if upto is None else _same(g[:upto], w[:upto])):
            raise AssertionError(f"{what}: output {i} differs")


def phase_k13_main_shapes(dev, seqs_a):
    """K13 through ``fingerprint_hashes_fused(variant="inline")`` at the CFL
    main path's shape: a.fasta's 512 000 shift windows of 100 bases as
    ``[B, 100]`` rows, under byte4 and dna16, with the counts set to 0 just
    before and read just after.  Under both packs (the reads are pure ACGT)
    it must equal K1's ``(h1, h2, count)`` of the same windows, its plain
    version on every row, and the split variant of the same entry point (K1
    on the rows).  Returns K13's record: ``ms`` under byte4, ``dna16_ms``
    beside it, and both through the C entry point alone (``launch_ms``,
    ``dna16_launch_ms``)."""
    import torch

    from fpmash_tpu_torch.ops import fused_cuda

    flat, starts, lengths = _main_stream(dev, seqs_a)
    if int(lengths.max()) > WINDOW or int(lengths.min()) < WINDOW:
        raise AssertionError("a.fasta's windows are not all 100 bases")
    rows = flat[starts[:, None] + torch.arange(WINDOW, device=dev)].contiguous()
    B = rows.shape[0]
    k1 = fused_cuda.fingerprint_hashes(flat, starts, lengths, 42)
    _reset_counts()
    got = {pack: fused_cuda.fingerprint_hashes_fused(rows, lengths, 42, pack, "inline")
           for pack in fused_cuda.PACKS}
    launches = _launches()["fingerprint_inline"]
    if launches < len(fused_cuda.PACKS):
        raise AssertionError(f"fingerprint_hashes_fused(variant='inline') launched K13 "
                             f"{launches} times")
    err = 0.0
    for pack, g in got.items():
        _check_equal(f"K13 {pack} vs K1", g, k1)
        want = fused_cuda.fingerprint_hashes_fused_plain(rows, lengths, 42, pack)
        _check_equal(f"K13 {pack} vs its plain version", g, want)
        _check_equal(f"split variant {pack} vs K1",
                     fused_cuda.fingerprint_hashes_fused(rows, lengths, 42, pack, "split"), k1)
        err = max(err, _max_abs_err(zip(g, want)))
    ms = {pack: _time_ms(lambda p=pack: fused_cuda.fingerprint_hashes_fused(
        rows, lengths, 42, p, "inline"), 50) for pack in fused_cuda.PACKS}
    launch = {pack: _time_ms(_fingerprint_rows_launch(rows, lengths, pack), 50)
              for pack in fused_cuda.PACKS}
    rec = {
        "max_abs_err": err,
        "ms": ms["byte4"],
        "dna16_ms": ms["dna16"],
        "launch_ms": launch["byte4"],
        "dna16_launch_ms": launch["dna16"],
        "plain_ms": _time_ms(lambda: fused_cuda.fingerprint_hashes_fused_plain(
            rows, lengths, 42, "byte4"), 3),
        # rows and lengths in, h1, h2 and count out; Duval reads each
        # character once, then MurmurHash3 of the factor lengths (as K1)
        **_bound(rows.numel() + B * (4 + 20),
                 int(lengths.sum()) + _hash_ops(k1[2], B)),
        "launches": launches,
    }
    print(f"main-path shapes: K13 (fingerprint_hashes_fused inline) at {B} rows of {WINDOW} "
          f"equal to K1, to the split variant and to its plain version under byte4 and dna16; "
          f"kernel byte4 {ms['byte4']:.4f} ms, dna16 {ms['dna16']:.4f} ms (C entry point "
          f"alone {launch['byte4']:.4f} and {launch['dna16']:.4f} ms), plain "
          f"{rec['plain_ms']:.4f} ms; launches {launches}")
    return rec


#: 32-bit operations of one compare-exchange of K15's network: the unsigned
#: compare and the selects of the key and payload pairs
SORT_CE_OPS = 5


def phase_kmer_variants(dev, work: Path):
    """K10, K11, K12 and K15 through their entry points at the classic main
    path's shape, g1.fna's chunk of 16 Mi positions at k = 21 and the s =
    1000 threshold, with the counts set to 0 just before and read just
    after: K11 on the chunk's packed windows F and R; K12 on its codes (16
    Mi = 1 024 blocks of 16 384, so the last windows wrap to the head) and
    on its first 16 Mi - 5 codes (no wrap); K10 on its codes; K15 on K6's
    masked planes of it at s = 1000 as ``[4096, 4096]`` (keys the high
    plane, payload the low: bottom-k's candidate row sort).  K11 must equal
    K7's hash at every position, K12 K7's planes and validity at every
    position up to N - k, K10 K5's survivors as a multiset with neither
    overflowing, K15's keys ``torch.sort``'s; each must equal its plain
    version at every position or slot.  Returns their records."""
    import torch

    from fpmash_tpu_torch.models import sketch as port_sketch
    from fpmash_tpu_torch.ops import kmers
    from fpmash_tpu_torch.ops import kmers_cuda as kc
    from fpmash_tpu_torch.ops import sort_cuda
    from fpmash_tpu_torch.ops.murmur3 import _SIGN
    from fpmash_tpu_torch.utils.fasta import read_sequences

    k = 21
    seqs = [r.seq for r in read_sequences(str(work / "classic" / "g1.fna"))]
    seq, length = port_sketch._direct_chunk(port_sketch._blob(seqs, k), 0, dev)
    N = seq.numel()
    codes = torch.from_numpy(kmers._CODES).to(dev)[kmers._fold_case(seq, False).long()]
    F, R, _ = kmers._pack_windows(torch.nn.functional.pad(codes, (0, k - 1), value=4), N, k)
    codes = codes.to(torch.int32)
    short = codes[: N - 5]
    t_hi = kmers.chunk_threshold(N, k, 1000)[0]
    mlo, mhi = kc.kmer_hashes_masked_planes(seq, t_hi, length, k=k)
    keys = mhi.view(-1, sort_cuda.COLS)
    payload = mlo.view(-1, sort_cuda.COLS)

    _reset_counts()
    k11 = kc.canonical_murmur(F, R, k=k)
    k12 = kc.kmer_hashes_fused_planes(codes, k=k)
    k12_short = kc.kmer_hashes_fused_planes(short, k=k)
    k10 = kc.kmer_hashes_packed_topk_planes(codes, t_hi, length, k=k)
    k15 = sort_cuda.row_sort_planes(keys, payload)
    torch.cuda.synchronize()
    launches = _launches()
    need = {"kmer:canonical_murmur": 1, "kmer:codes_planes": 2, "kmer:topk_groups": 1,
            "row_sort": 1}
    short_of = {key: launches[key] for key, n in need.items() if launches[key] < n}
    if short_of:
        raise AssertionError(f"the entry points did not launch their kernels: {launches}")

    k7 = kc.kmer_hashes_planes(seq, k=k)
    h7 = kc.join_planes(k7[0], k7[1])
    out = {}

    if not _same(k11, h7):
        raise AssertionError("K11 differs from K7's hash on g1's chunk")
    want = kc.canonical_murmur_plain(F, R, k=k)
    _check_equal("K11 vs its plain version", (k11,), (want,))
    out["k11"] = {
        "max_abs_err": _max_abs_err([(k11, want)]),
        "ms": _time_ms(lambda: kc.canonical_murmur(F, R, k=k), 20),
        "plain_ms": _time_ms(lambda: kc.canonical_murmur_plain(F, R, k=k), 3),
        # F and R in, h1 out; per position the canonical pick, then
        # MurmurHash3 of the k bytes
        **_bound(N * (8 + 8 + 8), N * (2 + MURMUR_WORD_OPS * -(-k // 8) + MURMUR_FINAL_OPS)),
        "launches": launches["kmer:canonical_murmur"],
    }

    err = 0.0
    for inp, got in ((codes, k12), (short, k12_short)):
        _check_equal(f"K12 at {inp.numel()} codes vs K7", got, k7, inp.numel() - k + 1)
        want = kc.kmer_hashes_fused_planes_plain(inp, k=k)
        _check_equal(f"K12 at {inp.numel()} codes vs its plain version", got, want)
        err = max(err, _max_abs_err(zip(got, want)))
    out["k12"] = {
        "max_abs_err": err,
        "ms": _time_ms(lambda: kc.kmer_hashes_fused_planes(codes, k=k), 20),
        "plain_ms": _time_ms(lambda: kc.kmer_hashes_fused_planes_plain(codes, k=k), 3),
        # codes in, planes and validity out; per position as K7
        **_bound(N * (4 + 4 + 4 + 1), N * (10 + MURMUR_WORD_OPS * -(-k // 8) + MURMUR_FINAL_OPS)),
        "launches": launches["kmer:codes_planes"],
    }

    want = kc.kmer_hashes_packed_topk_planes_plain(codes, t_hi, length, k=k)
    _check_equal("K10 vs its plain version", k10, want)
    if bool(k10[2]) or bool(want[2]):
        raise AssertionError("K10 overflowed a group on g1's chunk")
    k5 = kc.kmer_hashes_topk8_planes(seq, t_hi, length, k=k)
    if bool(k5[2]):
        raise AssertionError("K5 overflowed a group on g1's chunk")

    def survivors(planes):
        h = kc.join_planes(planes[0], planes[1])
        return torch.sort(h[h != -1] ^ _SIGN).values

    kept = survivors(k10)
    if not _same(kept, survivors(k5)) or kept.numel() < 1000:
        raise AssertionError(f"K10's {kept.numel()} survivors differ from K5's as a multiset")
    out["k10"] = {
        "max_abs_err": _max_abs_err(zip(k10, want)),
        "ms": _time_ms(lambda: kc.kmer_hashes_packed_topk_planes(codes, t_hi, length, k=k), 20),
        "plain_ms": _time_ms(lambda: kc.kmer_hashes_packed_topk_planes_plain(
            codes, t_hi, length, k=k), 3),
        # codes in, the N / 16 slots and the flag out; per position as K5,
        # and an insertion into the 8-entry list per survivor (3 operations
        # an entry)
        **_bound(N * 4 + k10[0].numel() * 8 + 4,
                 N * (10 + MURMUR_WORD_OPS * -(-k // 8) + MURMUR_FINAL_OPS)
                 + 24 * kept.numel()),
        "launches": launches["kmer:topk_groups"],
    }

    want = sort_cuda.row_sort_planes_plain(keys, payload)
    _check_equal("K15 vs its plain version", k15, want)

    def library_sort():
        order = torch.sort(keys ^ -(1 << 31), dim=1)
        return order.values ^ -(1 << 31), torch.gather(payload, 1, order.indices)

    if not _same(k15[0], library_sort()[0]):
        raise AssertionError("K15's keys differ from torch.sort's")
    C = keys.shape[0]
    steps = sum(range(1, sort_cuda.COLS.bit_length()))  # 78 for rows of 4 096
    out["k15"] = {
        "max_abs_err": _max_abs_err(zip(k15, want)),
        "ms": _time_ms(lambda: sort_cuda.row_sort_planes(keys, payload), 20),
        "plain_ms": _time_ms(lambda: sort_cuda.row_sort_planes_plain(keys, payload), 3),
        # keys and payload in and out once; the network's compare-exchanges
        **_bound(keys.numel() * 4 * 4, steps * (sort_cuda.COLS // 2) * C * SORT_CE_OPS),
        "launches": launches["row_sort"],
    }
    out["k15"]["library_ms"] = _time_ms(library_sort, 20)
    print(f"main-path shapes: g1's chunk of {N} positions, k = {k}: K11 equals K7's hash, K12 "
          f"K7's planes to N - k (at {N} codes, wrapping, and {short.numel()}), K10 K5's "
          f"{kept.numel()} survivors, K15's keys torch.sort's; each equals its plain version; "
          + "; ".join(f"{name.upper()} kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms"
                      for name, t in out.items())
          + f"; torch.sort + gather {out['k15']['library_ms']:.4f} ms; launches "
          f"{ {key: launches[key] for key in need} }")
    return out["k10"], out["k11"], out["k12"], out["k15"]


# ---------------------------------------------------------------------- #
# windowed sketches and find
# ---------------------------------------------------------------------- #

#: the windowed phase's reference: a bacterial chromosome and a plasmid
#: with planted Ns and lower case; queries: reads cut from the chromosome
#: (1 % substitutions, every second one reverse-complemented) and random ones
CHROMOSOME_LEN, PLASMID_LEN = 5_000_000, 200_000
FIND_READS, FIND_RANDOM, FIND_READ_LEN = 100, 20, 5_000
#: find's defaults: k, -L and mins = L / f (-f 100)
FIND_K, FIND_WINDOW, FIND_MINS = 21, 10_000, 100


def _fasta_record(name: str, text) -> bytes:
    """One FASTA record of ``uint8`` bytes ``text`` in lines of 80."""
    return (f">{name}\n".encode()
            + b"".join(text[i : i + 80].tobytes() + b"\n" for i in range(0, len(text), 80)))


def _minmer_bound(n: int) -> dict:
    """The minmer selection's bound over ``n`` positions, whatever computes
    it: the hashes and their previous occurrences read once (16 bytes a
    position) and the marks written once (1 byte)."""
    return _bound(17 * n, 0)


def _minmer_launches_by_shape(shapes) -> dict:
    """The minmer kernel's launches (``ops/winnow.LAUNCH_SHAPES``, keyed by
    ``(n, ws, mins)``) by the shapes of the windowed phase: find's query
    strands (the window clamped to the strand: one start), the chromosome
    and the plasmid at find's window, the plasmid at -k 16 (-L 1 000)."""
    out = {"query strands": 0, f"-L {FIND_WINDOW}": 0, "-k 16 -L 1000": 0, "other": 0}
    for (n, ws, _), count in shapes.items():
        key = ("query strands" if ws == n < FIND_WINDOW else f"-L {FIND_WINDOW}"
               if ws == FIND_WINDOW else "-k 16 -L 1000" if ws == 1000 else "other")
        out[key] += count
    return out


#: the windowed phase's worst case for the minmer kernel: 1 000 000
#: positions of 3 distinct hashes at find's window and mins
WORST_LEN, WORST_VALUES = 1_000_000, 3


def phase_windowed_find(dev, rng, work: Path):
    """``sketch -W`` and ``find`` through the CLI on cuda at find's defaults
    (k = 21, -L 10 000, mins 100): a 5 000 000-base chromosome and a
    200 000-base plasmid sketched to ``ref.msw``; ``find ref.msw`` and
    ``find ref.fa`` (sketched again on the fly) of 100 planted reads of
    5 000 bases and 20 random ones; ``sketch -W -k 16`` of the plasmid (K8,
    32-bit hashes).  Counts set to 0 before, read after: the position hashes
    must have launched K7 and K8.  Checks: both ``find`` runs print the same
    lines; every planted read is reported on the chromosome within its
    planted interval on its strand, and no random read is; the plasmid's
    position hashes on the card equal the scalar MurmurHash3 of its raw
    bytes and its loci the scalar minmer model over them (at k = 16 the
    plain ``murmur3_bytes_batch``'s 32-bit hashes).  The CLI runs must have
    launched the minmer kernel (``csrc/winnow.cu``).  Then the kernel is held
    byte for byte against its plain version on the card over the whole
    chromosome (``minmer_marks_plain``, timed once on the host clock), over
    WORST_LEN positions of WORST_VALUES hashes, over a query strand (the
    first planted read's 4 980 positions, the window clamped to them) and
    over the plasmid's 199 985 positions at -k 16 (-L 1 000, mins 10), and
    on one chunk of 1 677 starts (16 Mi window elements, the plain
    version's chunk on the card) ``minmer_positions`` on the card equals its
    CPU run; each is timed warm with CUDA events.  The CLI runs' minmer
    launches are counted by shape, and their peak device memory kept.
    Returns the launches and the kernel's record."""
    import io

    import numpy as np
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models.sketch import Sketch, SketchParams, position_hashes
    from fpmash_tpu_torch.ops import winnow as winnow_mod
    from fpmash_tpu_torch.ops.murmur3 import murmur3_bytes_batch
    from fpmash_tpu_torch.ops.winnow import (
        CHUNK_ELEMS,
        chunk_marks,
        minmer_marks,
        minmer_marks_plain,
        minmer_positions,
        prev_occurrence,
    )
    from fpmash_tpu_torch.scalar.murmur3 import hash_bytes
    from fpmash_tpu_torch.scalar.winnow import minmer_position_hashes
    from fpmash_tpu_torch.utils import trace as trace_mod

    out = work / "windowed"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    lut = np.frombuffer(b"ACGT", np.uint8)
    chrom = rng.integers(0, 4, size=CHROMOSOME_LEN, dtype=np.uint8)
    plasmid = lut[rng.integers(0, 4, size=PLASMID_LEN)]
    plasmid[rng.integers(0, PLASMID_LEN, size=200)] = ord("N")
    plasmid[50_000:50_100] = ord("N")
    plasmid[rng.integers(0, PLASMID_LEN, size=200)] |= 32
    plasmid[120_000:125_000] |= 32  # a lower-case run
    ref, pla, qry = out / "ref.fa", out / "plasmid.fa", out / "q.fa"
    ref.write_bytes(_fasta_record("chr synthetic chromosome", lut[chrom])
                    + _fasta_record("plasmid synthetic plasmid", plasmid))
    pla.write_bytes(_fasta_record("plasmid synthetic plasmid", plasmid))
    starts = rng.integers(0, CHROMOSOME_LEN - FIND_READ_LEN + 1, size=FIND_READS)
    reads = chrom[starts[:, None] + np.arange(FIND_READ_LEN)]
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + rng.integers(1, 4, size=int(err.sum()), dtype=np.uint8)) % 4
    minus = np.arange(FIND_READS) % 2 == 1
    reads[minus] = 3 - reads[minus, ::-1]
    rnd = rng.integers(0, 4, size=(FIND_RANDOM, FIND_READ_LEN), dtype=np.uint8)
    qry.write_bytes(b"".join(_fasta_record(f"p{i}", lut[r]) for i, r in enumerate(reads))
                    + b"".join(_fasta_record(f"rnd{i}", lut[r]) for i, r in enumerate(rnd)))
    print(f"windowed: {CHROMOSOME_LEN}-base chromosome, {PLASMID_LEN}-base plasmid, "
          f"{FIND_READS} planted and {FIND_RANDOM} random reads of {FIND_READ_LEN} bases "
          f"written in {time.perf_counter() - t0:.1f} s")

    commands = {
        "sketch -W -s 100 ref.fa": ["sketch", "-W", "-s", str(FIND_MINS), str(ref),
                                    "-o", str(out / "ref")],
        "find ref.msw q.fa": ["find", str(out / "ref.msw"), str(qry)],
        "find ref.fa q.fa": ["find", str(ref), str(qry)],
        "sketch -W -k 16 -L 1000 -s 10 plasmid.fa": ["sketch", "-W", "-k", "16", "-L", "1000",
                                                     "-s", "10", str(pla),
                                                     "-o", str(out / "plasmid_k16")],
    }
    walls, spans, printed = {}, {}, {}
    trace_mod.enable(True)  # the stage spans go to stderr, captured below
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    for name, argv in commands.items():
        err_io, std = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err_io), contextlib.redirect_stdout(std):
            rc = main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        assert rc == 0, (name, rc, err_io.getvalue())
        spans[name] = [line[len("[fpmash] "):] for line in err_io.getvalue().splitlines()
                       if line.startswith("[fpmash] ") and "find-query" not in line]
        printed[name] = std.getvalue()
    launches = _launches()
    by_shape = _minmer_launches_by_shape(winnow_mod.LAUNCH_SHAPES)
    trace_mod.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["kmer:planes_k32"] < 1 or launches["kmer:planes_k16"] < 1:
        raise AssertionError(f"the windowed path did not launch K7 and K8: {launches}")
    if launches["winnow"] < 1:
        raise AssertionError(f"the windowed path did not launch the minmer kernel: {launches}")

    t0 = time.perf_counter()
    found = printed["find ref.msw q.fa"]
    if found != printed["find ref.fa q.fa"]:
        raise AssertionError("find ref.msw and find ref.fa printed different lines")
    hits: dict[str, list] = {}
    for line in found.splitlines():
        q, r, a, b, strand, score = line.split("\t")
        hits.setdefault(q, []).append((r, int(a), int(b), strand, float(score)))
    if any(q.startswith("rnd") for q in hits):
        raise AssertionError(f"find reported a random read: {sorted(hits)}")
    for i, (s0, m) in enumerate(zip(starts.tolist(), minus.tolist())):
        want = "-" if m else "+"
        got = hits.get(f"p{i}", [])
        ok = [h for h in got if h[0] == "chr" and h[3] == want
              and s0 <= h[1] <= h[2] <= s0 + FIND_READ_LEN - FIND_K]
        if not ok or len(ok) != len(got):
            raise AssertionError(f"planted read p{i} at {s0} ({want}): find reported {got}")
    scores = [h[4] for q in hits for h in hits[q]]

    p = SketchParams(kmer_size=FIND_K, sketch_size=FIND_MINS, window_size=FIND_WINDOW,
                     windowed=True)
    raw = plasmid.tobytes()
    scalar = [hash_bytes(raw[i : i + FIND_K]) for i in range(PLASMID_LEN - FIND_K + 1)]
    if position_hashes(raw, p, dev).cpu().numpy().view(np.uint64).tolist() != scalar:
        raise AssertionError("the plasmid's position hashes differ from the scalar murmur")
    sk = Sketch()
    sk.load_msh(str(out / "ref.msw"))
    idx = sk.reference_index("plasmid")
    loci = [(pos, h) for s, pos, h in sk.loci if s == idx]
    if loci != minmer_position_hashes(scalar, FIND_WINDOW, FIND_MINS):
        raise AssertionError("the plasmid's loci differ from the scalar minmer model")
    sk16 = Sketch()
    sk16.load_msh(str(out / "plasmid_k16.msw"))
    win = torch.from_numpy(plasmid).unfold(0, 16, 1)
    h16, _ = murmur3_bytes_batch(win.contiguous(), torch.full((win.shape[0],), 16), 42)
    h16 = (h16 & 0xFFFFFFFF).tolist()
    if [(pos, h) for _, pos, h in sk16.loci] != minmer_position_hashes(h16, 1000, 10):
        raise AssertionError("sketch -W -k 16: the plasmid's loci differ from the scalar model")
    checks = time.perf_counter() - t0

    ws, mins = FIND_WINDOW, FIND_MINS
    hc = position_hashes(lut[chrom].tobytes(), p, dev)
    prev = prev_occurrence(hc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = minmer_marks_plain(hc, prev, ws, mins)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    marks = minmer_marks(hc, prev, ws, mins)
    if not torch.equal(marks, plain.to(torch.uint8)):
        raise AssertionError("the minmer kernel differs from its plain version on the chromosome")
    record = {"positions": hc.numel(), "window": ws, "mins": mins,
              "minmers": int(marks.sum()), "max_abs_err": _max_abs_err([(marks, plain)]),
              "ms": _time_ms(lambda: minmer_marks(hc, prev, ws, mins), 5), "plain_ms": plain_ms,
              **_minmer_bound(hc.numel())}
    del plain

    c = CHUNK_ELEMS["cuda"] // ws
    m = c + ws - 1
    t0 = time.perf_counter()
    on_cpu = minmer_positions(hc[:m], ws, mins, device="cpu")
    cpu_s = time.perf_counter() - t0
    on_card = minmer_positions(hc[:m], ws, mins, device=dev)
    if not all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu)):
        raise AssertionError("minmer_positions on the card differs from its CPU run")
    keys = hc[:m] ^ (-(1 << 63))
    record["chunk"] = {"starts": c, "ms": _time_ms(lambda: minmer_marks(hc[:m], prev[:m], ws,
                                                                      mins), 20),
                       "plain_ms": _time_ms(lambda: chunk_marks(keys, prev[:m], 0, c, ws, mins),
                                            5),
                       "bound_ms": _minmer_bound(m)["bound_ms"], "cpu_s": cpu_s}

    own = np.random.default_rng(2028)  # the later phases keep their inputs
    values = own.integers(0, 1 << 63, size=WORST_VALUES, dtype=np.uint64)
    hw = torch.from_numpy(values[own.integers(0, WORST_VALUES, size=WORST_LEN)]
                          .view(np.int64)).to(dev)
    pw = prev_occurrence(hw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = minmer_marks_plain(hw, pw, ws, mins)
    torch.cuda.synchronize()
    worst_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(minmer_marks(hw, pw, ws, mins), plain.to(torch.uint8)):
        raise AssertionError(f"the minmer kernel differs from its plain version on "
                             f"{WORST_VALUES} values")
    record["worst"] = {"positions": WORST_LEN, "values": WORST_VALUES,
                       "ms": _time_ms(lambda: minmer_marks(hw, pw, ws, mins), 5),
                       "plain_ms": worst_plain_ms, "bound_ms": _minmer_bound(WORST_LEN)["bound_ms"]}

    # the two shapes of the path's other launches: a find query strand (the
    # window clamped to its positions: one start) and the plasmid at -k 16
    raw16 = SketchParams(kmer_size=16, sketch_size=10, window_size=1000, windowed=True)
    for key, hx, wx, mx in (
            ("query", position_hashes(lut[reads[0]].tobytes(), p, dev), None, mins),
            ("plasmid_k16", position_hashes(raw, raw16, dev), raw16.window_size,
             raw16.sketch_size)):
        wx = min(wx or ws, hx.numel())
        px = prev_occurrence(hx)
        plain = minmer_marks_plain(hx, px, wx, mx)
        got = minmer_marks(hx, px, wx, mx)
        if not torch.equal(got, plain.to(torch.uint8)):
            raise AssertionError(f"the minmer kernel differs from its plain version ({key})")
        record[key] = {"positions": hx.numel(), "window": wx, "mins": mx,
                       "minmers": int(got.sum()),
                       "ms": _time_ms(lambda: minmer_marks(hx, px, wx, mx), 50),
                       "plain_ms": _time_ms(lambda: minmer_marks_plain(hx, px, wx, mx), 3),
                       "bound_ms": _minmer_bound(hx.numel())["bound_ms"]}
    record["launches_by_shape"] = by_shape
    record["phase_peak_gib"] = peak / 2**30

    for name in commands:
        print(f"windowed: {name}: {walls[name]:.3f} s wall; spans: " + "; ".join(spans[name]))
    print(f"windowed: {len(found.splitlines())} find lines, identical for ref.msw and ref.fa; "
          f"every planted read at its interval and strand (scores {min(scores):g}-"
          f"{max(scores):g}), no random read; {len(sk.loci)} loci, the plasmid's "
          f"{len(loci)} equal to the scalar model ({checks:.1f} s of checks)")
    print(f"windowed: launches K7 {launches['kmer:planes_k32']}, K8 "
          f"{launches['kmer:planes_k16']}, minmer kernel {launches['winnow']} (by shape: "
          f"{json.dumps(by_shape)}); peak device memory {peak / 2**30:.3f} GiB")
    print(f"windowed: the minmer kernel equals its plain version on the chromosome's "
          f"{record['positions']} positions, on {WORST_LEN} of {WORST_VALUES} values, on a "
          f"query strand and on the plasmid at -k 16, and its CPU run on one chunk of {c} "
          f"starts: " + json.dumps(record))
    return launches, record


# ---------------------------------------------------------------------- #
# host verbs
# ---------------------------------------------------------------------- #

#: the host-verb phase's taxonomy: root, a genus, a species and one strain
#: for each golden genome sketch (``mash_ref/genome{1,2,3}.fna.msh``)
TAX_NODES = ("1\t|\t1\t|\tno rank\t|\n561\t|\t1\t|\tgenus\t|\n"
             "562\t|\t561\t|\tspecies\t|\n11\t|\t562\t|\tstrain\t|\n"
             "12\t|\t562\t|\tstrain\t|\n13\t|\t562\t|\tstrain\t|\n")
TAX_NAMES = ("1\t|\troot\t|\t\t|\tscientific name\t|\n"
             "561\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"
             "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
             "11\t|\tE. coli K-12\t|\t\t|\tscientific name\t|\n"
             "12\t|\tE. coli O157:H7\t|\t\t|\tscientific name\t|\n"
             "13\t|\tE. coli BW25113\t|\t\t|\tscientific name\t|\n")

#: sha256 of each output of :func:`_host_verb_runs` through ``python -m
#: fpmash_tpu`` on the CPU (held against that CLI by
#: tests/test_torch_host_verbs.py)
HOST_VERB_SHA256 = {
    "paste:genomes3.msh": "d342e3a42b3ac752037fae8344cbbcce62331ca3e4579210550e452703702aa7",
    "paste -fp -o:fp.msh": "47816e9125909d24d6a365a5f6deab926307c7f7e5d3fe708ad91d15de87c6fc",
    "info -d DNA1": "54df580d2103513c1989fa8a60417d33c6cbfde134ea936fb25f1ca527d4f39b",
    "info -d DNA2": "a7449f3069042f191f6e5afbdab3f2d49a9e1a6b837b46865dcf61b79543724b",
    "info -d DNA3": "044a1444527136193b7f7e68ea492b64d67282a6573717ddb0605b847b7d4c22",
    "info -d reads": "37278666968a1616585357cd9f0bf52813de608f1c7335bb4e9da604dcc76dea",
    "info -H reads": "53921e47459a666538afb1db46b46577dcba84c865814edcc5ada14812b16b1a",
    "info -t reads": "a9173365956faa5cac324ef4c2c9c188a7b60edec303cd6c68c66df8514b0742",
    "info -c reads": "55e91e8ed16edd55269c5f86a7b3dcf9c060d9bf63f723d33927436c7cf38fcd",
    "bounds": "bebafa9ca6032158a2af6f76dacc2397ae46cb320e0a5b2795b325dfdc100060",
    "bounds -k 16 -p 0.95": "bbf21154ca868345d6e6917a5d13ebe8700e1c9a72d2efb96ad3f74db8315e7f",
    "contain": "dbf27b8247389e13bce9db7a9ac32a917c12e1f9ee2c378ffec1778f70aca6f2",
    "contain -C fastq": "57799c4857d6c4c6ac0651eb36132d628b5b27824c8a6f19b6ba055f9c065848",
    "taxscreen": "b6a6822a68f973d1956082494800f2ea45a5d500e6f3301d1ef276115ba772d9",
    "generate:gen.fasta": "b54db3f81115b37ecdab104fda26032fdb592bcd2e5b14c948b7663cf50cfd7e",
    "generate fastq:genq.fastq": "764ba02196b40c3bbbcd6f2d68e236af34687d5fe8614910bb87571970582379",
    "mapping:mapped_dna3.txt.txt": "614f9772bb650e6a6ce65d001a2f9c7abf4db2006c2451bb470f75cfbdaac7e9",
}


def _host_verb_runs(main, work: Path, device: list) -> dict:
    """Output bytes of ``paste``, ``info``, ``bounds``, ``contain``,
    ``taxscreen``, ``generate`` and ``mapping`` on golden inputs, through
    the CLI entry point ``main``: each verb's standard output, and the files
    it writes (keyed ``verb:file``).  ``work`` is emptied first; ``device``
    is appended to the verbs that take one (``contain``, ``taxscreen``)."""
    import io
    import shutil

    g = ROOT / "tests" / "golden"
    shutil.rmtree(work, ignore_errors=True)
    (work / "tax").mkdir(parents=True)
    out = {}

    def run(name, argv, files=()):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"{name}: exit code {rc}")
        if buf.getvalue() or not files:  # a verb that writes files prints nothing
            out[name] = buf.getvalue().encode()
        for f in files:
            out[f"{name}:{f}"] = (work / f).read_bytes()

    g3 = str(work / "genomes3.msh")
    run("paste", ["paste", g3, *(str(g / "mash_ref" / f"genome{i}.fna.msh") for i in (1, 2, 3))],
        ["genomes3.msh"])
    # -fp pastes a .txt operand's sibling .msh; -o takes the output last
    shutil.copy(g / "cfl" / "DNA3-CFL.txt", work / "dna3.txt")
    shutil.copy(g / "cfl" / "DNA3-sketch.msh", work / "dna3.msh")
    run("paste -fp -o", ["paste", "-fp", "-o", str(work / "dna3.txt"), str(work / "fp")],
        ["fp.msh"])
    for i in (1, 2, 3):
        run(f"info -d DNA{i}", ["info", "-d", str(g / "cfl" / f"DNA{i}-sketch.msh")])
    reads = str(g / "new_data" / "reads.msh")
    for flag in ("-d", "-H", "-t", "-c"):
        run(f"info {flag} reads", ["info", flag, reads])
    run("bounds", ["bounds"])
    run("bounds -k 16 -p 0.95", ["bounds", "-k", "16", "-p", "0.95"])
    run("contain", ["contain", "-e", "1", g3, reads, g3, *device])
    # a sequence file's reference is named by its path as given: relative here
    fastqs = [f"reads{i}.fastq" for i in (1, 2)]
    for f in fastqs:
        shutil.copy(g / "new_data" / f, work / f)
    with contextlib.chdir(work):
        run("contain -C fastq", ["contain", "-e", "0.5", "-C", g3, *fastqs, *device])
    fastqs = [str(work / f) for f in fastqs]
    (work / "tax" / "nodes.dmp").write_text(TAX_NODES)
    (work / "tax" / "names.dmp").write_text(TAX_NAMES)
    (work / "map.txt").write_text("11\tdata/genome1.fna\n12\tdata/genome2.fna\n"
                                  "13\tdata/genome3.fna\n")
    run("taxscreen", ["taxscreen", g3, *fastqs, "-t", str(work / "tax"),
                      "-m", str(work / "map.txt"), *device])
    gen = ["generate", "--size", "300", "--number_dna_generate", "4"]
    run("generate", [*gen, "--path", str(work / "gen"), "--gc_content", "0.4", "--seed", "7"],
        ["gen.fasta"])
    run("generate fastq", [*gen, "--path", str(work / "genq"), "--format", "fastq",
                           "--seed", "8"], ["genq.fastq"])
    run("mapping", ["mapping", "--path", str(work), "--fingerprint", "dna3.txt"],
        ["mapped_dna3.txt.txt"])
    return out


def _check_info_json(text: str, golden: Path) -> int:
    """``info -d``'s dump against a reference dump: the header, and each
    sketch's name and hashes (and counts, where the golden has them; the
    load truncates to the sketch size, as the reference's does).  Returns
    the number of hashes compared."""
    from fpmash_tpu_torch.utils.info_json import load_info_json

    mine, gold = load_info_json(text), load_info_json(str(golden))
    for key in ("kmer", "alphabet", "canonical", "sketchSize", "hashBits", "hashSeed"):
        if mine[key] != gold[key]:
            raise AssertionError(f"info -d {golden.name}: {key} {mine[key]} != {gold[key]}")
    if len(mine["sketches"]) != len(gold["sketches"]):
        raise AssertionError(f"info -d {golden.name}: sketch count differs")
    n = 0
    for m, s in zip(mine["sketches"], gold["sketches"]):
        if m["name"] != s["name"] or m["hashes"][: len(s["hashes"])] != s["hashes"]:
            raise AssertionError(f"info -d {golden.name}: sketch {s['name']} differs")
        if "counts" in s and m["counts"][: len(s["counts"])] != s["counts"]:
            raise AssertionError(f"info -d {golden.name}: counts of {s['name']} differ")
        n += len(s["hashes"])
    return n


def phase_host_verbs(work: Path):
    """``paste``, ``info``, ``bounds``, ``contain``, ``taxscreen``,
    ``generate`` and ``mapping`` through the port's CLI on golden inputs:
    ``contain`` and ``taxscreen`` (which sketch and hash FASTQs on the card,
    K7) on cuda, then every verb again with ``--device cpu``.  Every output
    must equal the CPU run's and the JAX package's (its digests,
    :data:`HOST_VERB_SHA256`), and ``info -d`` the reference's JSON dumps of
    the DNA goldens and of the reads golden."""
    import hashlib

    from fpmash_tpu_torch.cli import main

    t0 = time.perf_counter()
    _reset_counts()
    on_card = _host_verb_runs(main, work / "host_verbs_cuda", ["--device", "cuda"])
    launches = _launches()
    wall = time.perf_counter() - t0
    if launches["kmer:planes_k32"] < 1:
        raise AssertionError(f"contain and taxscreen did not launch K7: {launches}")
    on_cpu = _host_verb_runs(main, work / "host_verbs_cpu", ["--device", "cpu"])
    differ = sorted(k for k in on_card if on_card[k] != on_cpu.get(k))
    if differ or on_card.keys() != on_cpu.keys():
        raise AssertionError(f"host verbs: cuda and cpu runs differ in {differ}")
    digests = {k: hashlib.sha256(v).hexdigest() for k, v in on_card.items()}
    differ = sorted(k for k in digests.keys() | HOST_VERB_SHA256.keys()
                    if digests.get(k) != HOST_VERB_SHA256.get(k))
    if differ:
        raise AssertionError(f"host verbs: outputs differ from the JAX package's in {differ}")
    g = ROOT / "tests" / "golden"
    n = sum(_check_info_json(on_card[f"info -d DNA{i}"].decode(), g / "cfl" / f"DNA{i}-sketch.json")
            for i in (1, 2, 3))
    n += _check_info_json(on_card["info -d reads"].decode(), g / "new_data" / "reads.json")
    print(f"host verbs: {len(on_card)} outputs of paste, info, bounds, contain, taxscreen, "
          f"generate and mapping equal on cuda and cpu and to the JAX package's; info -d "
          f"equals the four JSON goldens ({n} hashes); cuda run {wall:.2f} s wall, "
          f"launches {launches}")
    return launches


# ---------------------------------------------------------------------- #
# the native host helpers: the FASTA/FASTQ reader and the host factorizer
# ---------------------------------------------------------------------- #


def edge_files() -> dict:
    """Small FASTA/FASTQ files on which the JAX package's two readers
    disagree (CRLF line ends with and without comments, blanks in sequence
    lines, CRLF FASTQ, blank lines between FASTQ records, a FASTQ sequence
    split over two lines) and one with a non-ASCII byte: ``{name: bytes}``."""
    import numpy as np

    rng = np.random.default_rng(13)
    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = [lut[rng.integers(0, 4, size=n)].tobytes().decode() for n in (300, 240, 180)]
    quals = ["I" * len(s) for s in seqs]
    return {
        "crlf_comments.fa": "".join(f">r{i} sample {i}\r\n{s[:150]}\r\n{s[150:]}\r\n"
                                    for i, s in enumerate(seqs)).encode(),
        "crlf_plain.fa": "".join(f">r{i}\r\n{s[:100]}\r\n{s[100:]}\r\n"
                                 for i, s in enumerate(seqs)).encode(),
        "blanks.fa": "".join(f">r{i} x\n{s[:150]}  \n\t{s[150:]} \t\n"
                             for i, s in enumerate(seqs)).encode(),
        "crlf.fq": "".join(f"@r{i} c\r\n{s}\r\n+\r\n{q}\r\n"
                           for i, (s, q) in enumerate(zip(seqs, quals))).encode(),
        "blank_lines.fq": "\n".join(f"@r{i} c\n{s}\n+\n{q}\n"
                                    for i, (s, q) in enumerate(zip(seqs, quals))).encode(),
        "multiline.fq": "".join(f"@r{i}\n{s[:120]}\n{s[120:]}\n+\n{q}\n"
                                for i, (s, q) in enumerate(zip(seqs, quals))).encode(),
        "non_ascii.fa": (f">r0 café\n{seqs[0][:50]}".encode()
                         + "é".encode() + f"{seqs[0][50:]}\n>r1\n{seqs[1]}\n".encode()),
    }


#: phase (d)'s long reads, and the chunks of each run held against the scalar model
LONG_READS, LONG_READ_LEN, LONG_SAMPLE = 2_000, 10_000, 1_000

#: the edge files that :func:`edge_file_runs` sketches and fingerprints
EDGE_CLI_FILES = ("crlf_comments.fa", "crlf_plain.fa", "blanks.fa", "crlf.fq", "blank_lines.fq")


def edge_file_runs(main, work: Path, sketch_extra: list, fingerprint_extra: list) -> dict:
    """Output bytes of ``sketch``, ``sketch -i``, ``sketch -r`` (the
    ``.msh``) and ``fingerprint`` (its two ``.txt`` files) of each file of
    :data:`EDGE_CLI_FILES` through the CLI entry point ``main``, keyed
    ``"<command>:<file>"``.  ``work`` is emptied first; ``sketch_extra`` and
    ``fingerprint_extra`` are appended to those verbs' arguments."""
    import io
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    files = edge_files()
    out = {}
    for name in EDGE_CLI_FILES:
        d = work / name.replace(".", "_")
        d.mkdir()
        (d / name).write_bytes(files[name])
        for tag, flags in (("sketch", []), ("sketch -i", ["-i"]), ("sketch -r", ["-r"])):
            o = tag.replace(" ", "").replace("-", "_")
            # a sequence file's reference is named by its path as given: relative here
            with contextlib.chdir(d), contextlib.redirect_stderr(io.StringIO()):
                rc = main(["sketch", *flags, name, "-o", o, *sketch_extra])
            if rc != 0:
                raise AssertionError(f"{tag} {name}: exit code {rc}")
            out[f"{tag}:{name}"] = (d / f"{o}.msh").read_bytes()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = main(["fingerprint", "--path", str(d), "--fasta", name, *fingerprint_extra])
        if rc != 0:
            raise AssertionError(f"fingerprint {name}: exit code {rc}")
        out[f"fingerprint:{name}"] = (d / "fingerprint_CFL.txt").read_bytes()
        out[f"fingerprint fact:{name}"] = (d / "fact_fingerprint_CFL.txt").read_bytes()
    return out


#: sha256 of each output of :func:`edge_file_runs` through ``python -m
#: fpmash_tpu`` on the CPU (``fingerprint`` with ``--backend scalar``; held
#: against that CLI by tests/test_torch_native_io.py)
EDGE_SHA256 = {
    "sketch:crlf_comments.fa": "66695b086e0077980dec0edbb74636e5880deb441bb7ddc8f0c5e5a71b80e272",
    "sketch -i:crlf_comments.fa": "c6f389c4135ebc5ba67030c7166c975d4e606e1d97dcb29a009651f8ae505354",
    "sketch -r:crlf_comments.fa": "343c36c32f8aa719ee2958b0f053a9c31f1b836e57e7dff28ba33785ebe0f14e",
    "fingerprint:crlf_comments.fa": "916627abb03eaec0ce70846ed6f50281419bb22f3f52026a96a98819c0513d85",
    "fingerprint fact:crlf_comments.fa": "0da30342a89446975c2d296bdb9c51a288400de8dd29a86be3d1f93d4afa2371",
    "sketch:crlf_plain.fa": "de143dc724291e4779a22d1d267244e31c4fd1d0ad14e255143a16d4f5466dc3",
    "sketch -i:crlf_plain.fa": "9375f13fb3980fd49c0861a961aff771d07e4d884498377e83fc2b529991ecd2",
    "sketch -r:crlf_plain.fa": "87899251a7f7f80ce525b12d3e6c6f2c921a3c5dfc9ffacf2311a9f6796e1bdb",
    "fingerprint:crlf_plain.fa": "d3d0d2fe314c1ddf5a0ff8e7c4c434cd301c9458712638a25d8e550f5c5dc7cd",
    "fingerprint fact:crlf_plain.fa": "0aaf8febd60ffe0dbc183c18563219df909430a0d342fcd414f78d2dcce368ba",
    "sketch:blanks.fa": "61042702508bdf86ade7a7c462cc8900588092da12d4b81a79020062bc242cae",
    "sketch -i:blanks.fa": "eece94f4ee3ae3449dd515b2dbe56c0ad7cdabdff4b15758e870f89178df1794",
    "sketch -r:blanks.fa": "57a0a20d25f04a7e60ad696be84e26a345d83f297eace5eadcbaa761dfa5e953",
    "fingerprint:blanks.fa": "983b1c8244e7288e911dc820a6d2828fed8db48a3b2b2d054b3caaff983b8cab",
    "fingerprint fact:blanks.fa": "ab1977de2a398cca890f1d5cf6a1639fc2666c918eb1f9a8f0ce7545b8cacd74",
    "sketch:crlf.fq": "52aa994e5199dad8b5e5e00399aa45e1e460c16166e45ebd833de1fee464b934",
    "sketch -i:crlf.fq": "50b3ff8ac01de1a749024468ffc373556fec4026da85078ec909ad98f5da12ff",
    "sketch -r:crlf.fq": "0871f861a6c536c341ebaf74c5ff2a34f985bc72822fa09e81de7a7d9e2ef783",
    "fingerprint:crlf.fq": "a278cef682d655257177e9f93d5842e274437eaa2704996240d010919259ba9d",
    "fingerprint fact:crlf.fq": "0fb2710ebb5bdc475b791d624a166ebf7600944ab284250082070d72d36a9236",
    "sketch:blank_lines.fq": "c55dfcd6817aa82be5daad06008505c91ff71c7b9c1c7358a458296f35f1a580",
    "sketch -i:blank_lines.fq": "fdefa0c86768fcc6dc6cc44fa30e5bdf73c5184487726e8a53e760ff7b7502ee",
    "sketch -r:blank_lines.fq": "dabe8ca367c0cb21f5d71c8a5d672babacc8b1037d7b137cf24d2d0eec5bdc79",
    "fingerprint:blank_lines.fq": "a70fb88077e86f0a65faf885b646f6f851e68e3cafa773707ff1b850b33acba8",
    "fingerprint fact:blank_lines.fq": "2ccabb0fb3178c48a34842a19dfc370f922f41c6e244e9afeaec7163e2531b50",
}

_PARSE = """
import hashlib, json, os, sys, threading, time
sys.path.insert(0, {root!r})
from fpmash_tpu_torch.utils.fasta import read_sequences
if {native!r}:
    from fpmash_tpu_torch.utils import native
    native._lib()  # the import and the library's load are not the parse's

def rss_gib():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30

peak, done = [rss_gib()], threading.Event()

def sample():  # the C++ parse releases the GIL, so this samples it too
    while not done.wait(0.01):
        peak[0] = max(peak[0], rss_gib())

before = peak[0]
sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
records = list(read_sequences({path!r}, native={native!r}))
wall = time.perf_counter() - t0
done.set()
sampler.join()
digest = hashlib.sha256()
for r in records:
    digest.update("\\0".join(r).encode() + b"\\n")
print(json.dumps({{"wall": wall, "records": len(records), "sha256": digest.hexdigest(),
                  "rss_before_gib": before, "peak_rss_gib": max(peak[0], rss_gib())}}))
"""


def _parse_runs(path: Path) -> dict:
    """``read_sequences`` of ``path`` by the native reader and by the Python
    one (``native=False``), each in a process of its own (its wall, its peak
    resident memory before and after the parse, and a digest of every
    record's name, comment and sequence); raises unless the two readers give
    the same records."""
    import subprocess

    runs = {}
    for tag, native in (("native", True), ("python", False)):
        proc = subprocess.run([sys.executable, "-c", _PARSE.format(root=str(ROOT), path=str(path),
                                                                   native=native)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{path.name}: the {tag} reader's process failed "
                                 f"(exit {proc.returncode}):\n{proc.stderr}")
        runs[tag] = json.loads(proc.stdout.strip().splitlines()[-1])
    if runs["native"]["sha256"] != runs["python"]["sha256"]:
        raise AssertionError(f"{path.name}: the native and Python readers give other records")
    return runs


def _parse_line(what: str, runs: dict) -> str:
    n, p = runs["native"], runs["python"]
    return (f"{what}: {n['records']} records parsed in {n['wall']:.3f} s native, "
            f"{p['wall']:.3f} s Python ({p['wall'] / n['wall']:.2f}x), the same records; peak "
            f"RSS {n['peak_rss_gib']:.3f} GiB native, {p['peak_rss_gib']:.3f} GiB Python "
            f"({n['rss_before_gib']:.3f} and {p['rss_before_gib']:.3f} GiB before the parse)")


def _fingerprint_rows(path: Path) -> list[list[list[int]]]:
    """Each line of a generalized fingerprint file: its chunks' lengths."""
    rows = []
    for line in path.read_text().splitlines():
        segments = line.split("  ", 1)[1].split(" | ")[:-1]
        rows.append([[int(x) for x in seg.split()] for seg in segments])
    return rows


def phase_native_host(dev, rng, work: Path, smi: str) -> dict:
    """The native host helpers (``fpmash_tpu_torch/native/``, built with
    g++ at first use) on the paths that run them, with the counts set to 0
    just before each CLI run and read just after:

    (a) BASELINE config 5's FASTQ (``phase_multi_device``'s 1 000 000 reads
        of 150 bases) parsed by both readers (same records; walls, peak
        resident memory), then ``sketch -r -m 2 reads.fq`` through the CLI
        on the card (K5), whose ``.msh`` must equal the one that phase built
        from the parsed records;
    (b) the classic workflow's 50 Mbase read set parsed by both readers;
    (c) the edge files (:func:`edge_files`) sketched and fingerprinted
        through the CLI on the card: every output must equal the JAX CLI's
        (:data:`EDGE_SHA256`);
    (d) ``fingerprint --type generalized --type_factorization ICFL_COMB``
        of 2 000 reads of 10 000 bases at ``--split 2000`` (every chunk
        wider than the card's ICFL bound, so factorized on the host by
        ``native/lyndon.cpp``) and at the default ``--split 300`` (K3), a
        sample of 1 000 chunks of each held against the scalar model.
    Returns the launches of the CLI runs."""
    import hashlib
    import io

    import numpy as np
    import torch

    from fpmash_tpu_torch.cli import main
    from fpmash_tpu_torch.models import fingerprint
    from fpmash_tpu_torch.ops.icfl_cuda import MAX_ICFL_WIDTH
    from fpmash_tpu_torch.utils import trace as trace_mod

    t_phase = time.perf_counter()
    launches = {}

    def cli(argv):
        """``main(argv)`` with the stage spans captured; its wall, launches,
        host rows and spans."""
        err = io.StringIO()
        trace_mod.enable(True)
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trace_mod.enable(False)
        if rc != 0:
            raise AssertionError(f"{' '.join(argv)}: exit code {rc}\n{err.getvalue()}")
        spans = [line[len("[fpmash] "):] for line in err.getvalue().splitlines()
                 if line.startswith("[fpmash] ")]
        return wall, _launches(), dict(fingerprint.SCALAR_ROWS), spans

    # (a) config 5
    reads = work / "config5" / "reads.fq"
    print(_parse_line(f"native host: (a) config 5 {reads.name}", _parse_runs(reads)) + f"; {smi}")
    out = work / "native_host"
    out.mkdir(parents=True, exist_ok=True)
    wall, got, _, spans = cli(["sketch", "-r", "-m", "2", str(reads), "-o", str(out / "config5"),
                               "--device", "cuda"])
    if got["kmer:topk8"] < 1:
        raise AssertionError(f"config 5 sketch -r -m 2 did not launch K5: {got}")
    if not any("read-sequences" in s and "reader=native" in s for s in spans):
        raise AssertionError(f"config 5 sketch -r -m 2 did not read with the native reader: "
                             f"{spans}")
    if (out / "config5.msh").read_bytes() != (work / "config5" / "reads_m2_1.msh").read_bytes():
        raise AssertionError("config 5: the CLI's .msh differs from the one built from the "
                             "parsed records")
    launches["config5"] = got
    print(f"native host: (a) config 5 sketch -r -m 2 reads.fq through the CLI on the card: "
          f"{wall:.3f} s wall, K5 launches {got['kmer:topk8']}, .msh equal to the one built "
          f"from the parsed records; spans: {'; '.join(spans)}; {smi}")

    # (b) the classic workflow's read set
    print(_parse_line("native host: (b) the classic read set reads.fq",
                      _parse_runs(work / "classic" / "reads.fq")) + f"; {smi}")

    # (c) the edge files on the card
    _reset_counts()
    outputs = edge_file_runs(main, out / "edge", ["--device", "cuda"], ["--device", "cuda"])
    got = {k: n for k, n in _launches().items() if n}
    digests = {k: hashlib.sha256(v).hexdigest() for k, v in outputs.items()}
    differ = sorted(k for k in digests.keys() | EDGE_SHA256.keys()
                    if digests.get(k) != EDGE_SHA256.get(k))
    if differ:
        raise AssertionError(f"edge files: outputs differ from the JAX CLI's in {differ}")
    launches["edge"] = got
    print(f"native host: (c) {len(outputs)} outputs of sketch, sketch -i, sketch -r and "
          f"fingerprint of {len(EDGE_CLI_FILES)} edge files (CRLF, blanks, blank FASTQ lines) on "
          f"the card equal the JAX CLI's; launches {got}")

    # (d) the host factorizer at 20 Mbases
    long_dir = out / "long"
    long_dir.mkdir(parents=True, exist_ok=True)
    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = lut[rng.integers(0, 4, size=(LONG_READS, LONG_READ_LEN))]
    fasta = long_dir / "long.fa"
    with open(fasta, "wb") as fh:
        for i, row in enumerate(seqs):
            fh.write(b">L%d long\n" % i)
            fh.write(b"\n".join(row[p : p + 70].tobytes() for p in range(0, LONG_READ_LEN, 70))
                     + b"\n")
    seqs = [row.tobytes().decode() for row in seqs]
    for split in (2000, 300):
        d = long_dir / f"split{split}"
        d.mkdir(exist_ok=True)
        wall, got, host_rows, spans = cli(
            ["fingerprint", "--type", "generalized", "--type_factorization", "ICFL_COMB",
             "--split", str(split), "--fasta", str(fasta), "--path", str(d), "--device", "cuda"])
        widths = [min(split, LONG_READ_LEN - p) for p in range(0, LONG_READ_LEN, split)]
        n_chunks = LONG_READS * len(widths)
        wide = LONG_READS * sum(w > MAX_ICFL_WIDTH for w in widths)
        if host_rows != {"wide": wide, "ok_false": 0}:
            raise AssertionError(f"--split {split}: {host_rows} rows on the host, not {wide} wide")
        if wide and not any("scalar-rows:wide" in s and "host=native" in s for s in spans):
            raise AssertionError(f"--split {split}: no native host span: {spans}")
        if wide < n_chunks and got["factor_words:icfl"] < 1:
            raise AssertionError(f"--split {split}: K3 not launched: {got}")
        rows = _fingerprint_rows(d / "fingerprint_ICFL_COMB.txt")
        if len(rows) != LONG_READS or any(len(r) != len(widths) for r in rows):
            raise AssertionError(f"--split {split}: {len(rows)} lines, not {LONG_READS}")
        t0 = time.perf_counter()
        picks = rng.choice(n_chunks, LONG_SAMPLE, replace=False)
        for pick in picks:
            r, c = divmod(int(pick), len(widths))
            want = fingerprint.scalar_lengths(seqs[r][c * split : (c + 1) * split], "ICFL_COMB")
            if rows[r][c] != want:
                raise AssertionError(f"--split {split}: read {r} chunk {c} differs from the "
                                     "scalar model")
        launches[f"long split {split}"] = got
        print(f"native host: (d) fingerprint --type generalized ICFL_COMB --split {split} of "
              f"{LONG_READS} reads x {LONG_READ_LEN} bases ({n_chunks} chunks): {wall:.3f} s wall; "
              f"rows on the host {host_rows}; launches {({k: n for k, n in got.items() if n})}; "
              f"{LONG_SAMPLE} chunks "
              f"equal the scalar model ({time.perf_counter() - t0:.1f} s); spans: "
              f"{'; '.join(spans)}; {smi}")
    print(f"native host: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    err2, k2_random = phase_k2(dev, rng)
    errs = phase_factor_kernels(dev, rng)
    phase_golden(work)
    family_launches, k14_golden = phase_families_golden(work)
    launches, seqs_a = phase_main_path(dev, rng, work, "CFL")
    k1, k2 = phase_main_shapes(dev, work, seqs_a)
    k13 = phase_k13_main_shapes(dev, seqs_a)
    icfl_launches, seqs_i = phase_main_path(dev, rng, work, "ICFL_COMB")
    k3, k4, k14 = phase_icfl_main_shapes(dev, work, seqs_i)
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    k2["max_abs_err"] = max(k2["max_abs_err"], err2)
    k2["random_lists"] = k2_random
    k3["max_abs_err"] = max(k3["max_abs_err"], errs["icfl"])
    k4["max_abs_err"] = max(k4["max_abs_err"], errs["hash_words"])
    k14["max_abs_err"] = max(k14["max_abs_err"], errs["cfl"])
    k14["golden"] = k14_golden

    kmer_errs = phase_kmer_kernels(dev, rng)
    phase_classic_goldens(work)
    classic_launches, _ = phase_classic_main_path(dev, rng, work)
    k5, k6, k7, k8 = phase_kmer_main_shapes(dev, work)
    for t, key in ((k5, "topk8"), (k6, "masked"), (k7, "planes_k32"), (k8, "planes_k16")):
        t["max_abs_err"] = max(t["max_abs_err"], kmer_errs[key])
    k10, k11, k12, k15 = phase_kmer_variants(dev, work)
    for t, key in ((k10, "topk_groups"), (k11, "canonical_murmur"), (k12, "codes_planes")):
        t["max_abs_err"] = max(t["max_abs_err"], kmer_errs[key])

    err9 = phase_k9(dev, rng)
    config4_launches, k9, k2_all_pairs, _, config4 = phase_config4(dev, rng, work)
    # a generator of its own: the later phases keep their inputs
    phase_multi_device(dev, np.random.default_rng(2027), work, config4, seqs_a)
    del config4
    k2.update(k2_all_pairs)
    k9["max_abs_err"] = max(k9["max_abs_err"], err9)

    windowed_launches, minmer = phase_windowed_find(dev, rng, work)
    k7["windowed_launches"] = windowed_launches["kmer:planes_k32"]
    k8["windowed_launches"] = windowed_launches["kmer:planes_k16"]
    phase_host_verbs(work)
    phase_native_host(dev, rng, work, smi)

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
         + family_launches["factor_words:cfl_icfl"],
         "launches_by_base": {"cfl": family_launches["factor_words:cfl"],
                              "cfl_icfl": family_launches["factor_words:cfl_icfl"]}, **k14},
        {"name": "kmer_topk8", "route": "cuda", "source": src + "kmer_hash.cu",
         "replaces": "fpmash_tpu/ops/kmers_pallas.py:762",
         "launches": classic_launches["kmer:topk8"], **k5},
        {"name": "kmer_masked", "route": "cuda", "source": src + "kmer_hash.cu",
         "replaces": "fpmash_tpu/ops/kmers_pallas.py:544",
         "launches": classic_launches["kmer:masked"], **k6},
        {"name": "kmer_hashes_k32", "route": "cuda", "source": src + "kmer_hash.cu",
         "replaces": "fpmash_tpu/ops/kmers_pallas.py:510",
         "launches": classic_launches["kmer:planes_k32"], **k7},
        {"name": "kmer_hashes_k16", "route": "cuda", "source": src + "kmer_hash.cu",
         "replaces": "fpmash_tpu/ops/kmers_pallas.py:411",
         "launches": classic_launches["kmer:planes_k16"], **k8},
        {"name": "compare", "route": "cuda", "source": src + "compare.cu",
         "replaces": "fpmash_tpu/ops/compare_pallas.py:41",
         "launches": config4_launches["compare"], **k9},
        # no Pallas kernel: an XLA jit in the JAX package
        {"name": "winnow", "route": "cuda", "source": src + "winnow.cu",
         "replaces": "fpmash_tpu/ops/winnow.py:105", "launches": windowed_launches["winnow"],
         **minmer},
    ]
    # unrouted in the JAX package: launched by their phases through the
    # entry points of the JAX functions they replace
    for name, source, replaces, entry, rec in (
            ("kmer_topk_groups", "kmer_hash.cu", "kmers_pallas.py:619",
             "ops/kmers_cuda.kmer_hashes_packed_topk_planes", k10),
            ("canonical_murmur", "kmer_hash.cu", "kmers_pallas.py:142",
             "ops/kmers_cuda.canonical_murmur", k11),
            ("kmer_codes_hashes", "kmer_hash.cu", "kmers_pallas.py:225",
             "ops/kmers_cuda.kmer_hashes_fused[_planes]", k12),
            ("fingerprint_inline", "fingerprint.cu", "fused_pallas.py:189",
             "ops/fused_cuda.fingerprint_hashes_fused(variant='inline')", k13),
            ("row_sort", "row_sort.cu", "sort_pallas.py:28", "ops/sort_cuda.row_sort_planes",
             k15)):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": "fpmash_tpu/ops/" + replaces,
                        "entry_point": "fpmash_tpu_torch/" + entry,
                        "routed_in_reference": False, **rec})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
