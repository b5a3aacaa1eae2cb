"""`find` — windowed region search (CommandFind.cpp:27-425).

The reference argument is a windowed sketch (``.msw``) or a FASTA that is
windowed-sketched on the fly; each query sequence's minmers (both strands)
are matched against the sketch's loci, and runs of matched reference
positions within a query-length window are reported as regions with
``score = matched loci / query minmers``.  Flags, defaults and output bytes
are those of ``python -m fpmash_tpu find``; ``--device`` replaces
``--backend``.  Position hashes run on the k-mer hash kernels (K7/K8) and
the minmer selection on the device (``ops/winnow.py``).

The JAX package's deviation from the reference, kept here (PARITY.md):
``findPerStrand`` hashes queries with a default-constructed parameter set
(seed 0, CommandFind.cpp:276 + Sketch.h:49) while the reference sketch
hashes with the CLI seed (default 42), so upstream's query hashes can never
match its sketch; queries are hashed with the sketch's own seed and hash
width instead.
"""

from __future__ import annotations

import sys
from functools import cmp_to_key

import numpy as np

from fpmash_tpu_torch.commands.common import add_device_option
from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.models.sketch import Sketch, SketchParams, position_hashes
from fpmash_tpu_torch.scalar.stats import format_g
from fpmash_tpu_torch.utils.trace import trace


def add_parser(sub):
    p = sub.add_parser(
        "find",
        help="Find regions of references that have similarity to query sequences.",
        description="Compare query sequences to a reference. <reference> can be "
        "a fasta file or a windowed sketch (.msw). <query> can be fasta or "
        "fastq, gzipped or not; '-' reads from standard input.",
    )
    p.add_argument("reference", metavar="<reference>")
    p.add_argument("queries", nargs="+", metavar="<query>")
    p.add_argument("-t", "--threshold", type=float, default=0.2, help="Threshold. This fraction of the query sequence's min-hashes must appear in a query-sized window of a reference sequence for the match to be reported. [0.2]")
    p.add_argument("-b", "--best", type=int, default=0, help="Best hit count. This many of the best hits will be reported (0 to report all hits). Score ties are broken by keeping the hit to the earlier reference or to the left-most position.")
    p.add_argument("--self", dest="self_", action="store_true", help="Ignore self matches if query ID appears in reference.")
    p.add_argument("-k", "--kmer", type=int, default=None, help="K-mer size when sketching a fasta reference. [21]")
    p.add_argument("-L", "--window", type=int, default=None, help="Window length when sketching a fasta reference. [10000]")
    p.add_argument("-f", "--factor", type=float, default=100.0, help="Compression factor: minmers per window = window/factor. [100]")
    p.add_argument("-S", "--seed", type=int, default=42, help="Hash seed when sketching a fasta reference. [42]")
    p.add_argument("-p", "--threads", type=int, default=1, help="Parallelism (interface parity).")
    add_device_option(p)
    p.set_defaults(func=run)
    return p


def _cpp_less(a, b) -> bool:
    """Hit ordering (CommandFind.cpp operator<): best = lowest by this."""
    if a[4] != b[4]:
        return a[4] > b[4]  # higher score is "less" (better)
    if a[0] != b[0]:
        return a[0] < b[0]  # earlier reference
    if a[1] != b[1]:
        return a[1] < b[1]  # left-most start
    return bool(b[3])  # plus strand before minus


def run(args) -> int:
    ref_path = args.reference
    if ref_path.endswith(".msh"):
        print(
            f"ERROR: Reference ({ref_path}) looks like a sketch but is not windowed.",
            file=sys.stderr,
        )
        return 1
    devices = placement.resolve_devices(args.device)

    sketch = Sketch()
    if ref_path.endswith(".msw"):
        # -k/-L are inherited from the sketch and cannot be overridden
        # (CommandFind.cpp:74-79)
        if args.kmer is not None or args.window is not None:
            print(
                "ERROR: The options -k and -L cannot be used when a sketch is "
                "provided; these are inherited from the sketch.",
                file=sys.stderr,
            )
            return 1
        sketch.load_msh(ref_path)
    else:
        window = 10000 if args.window is None else args.window
        params = SketchParams(
            kmer_size=21 if args.kmer is None else args.kmer,
            sketch_size=int(window / args.factor),
            seed=args.seed,
            windowed=True,
            window_size=window,
            concatenated=False,
        )
        print(f"Sketching {ref_path} (provide a .msw sketch to skip)...", file=sys.stderr)
        sketch = Sketch(params)
        sketch.init_from_files([ref_path], devices=devices)

    from fpmash_tpu_torch.utils.fasta import read_sequences

    k = sketch.params.kmer_size
    for qpath in args.queries:
        for rec in read_sequences(qpath):
            if len(rec.seq) < k:
                continue
            with trace("find-query", bases=len(rec.seq)):
                _find_query(sketch, rec.name, rec.seq, args, devices[0])
    return 0


def _find_query(sketch: Sketch, qname: str, qseq: str, args, device) -> None:
    from fpmash_tpu_torch.ops.winnow import minmer_positions

    p = sketch.params
    length = len(qseq)
    # unconditional case fold of every byte above 'Z' (CommandFind.cpp:211)
    seq = bytes(c - 32 if c > 90 else c for c in qseq.encode("ascii", "replace"))

    self_idx = sketch.reference_index(qname)
    self_matches = not args.self_

    hits: list[tuple] = []  # (ref, start, end, minus, score_f32)
    for minus in (False, True):
        strand = _rev_comp_acgt(seq) if minus else seq
        ph = position_hashes(strand, p, device)
        if ph.numel() == 0:
            continue
        _, mh = minmer_positions(ph, p.window_size, p.sketch_size, device=device)
        min_hashes = set(mh.tolist())
        if not min_hashes:
            continue

        # matched loci per reference, as sorted distinct positions
        by_ref: dict[int, list[int]] = {}
        for h in min_hashes:
            for seq_idx, pos in sketch.loci_by_hash(h):
                if seq_idx != self_idx or self_matches:
                    by_ref.setdefault(seq_idx, []).append(pos)

        for ref_idx, positions in by_ref.items():
            _cluster(sorted(set(positions)), length, len(min_hashes), ref_idx, minus,
                     args.threshold, args.best, hits)

    # heap pop order is worst-first; the reference reverses before printing
    # (writeOutput), i.e. ascending by the Hit comparator
    hits.sort(key=cmp_to_key(lambda a, b: -1 if _cpp_less(a, b) else (1 if _cpp_less(b, a) else 0)))
    out = sys.stdout
    for ref_idx, start, end, minus, score in hits:
        out.write(
            f"{qname}\t{sketch.references[ref_idx].name}\t{start}\t{end}\t"
            f"{'-' if minus else '+'}\t{format_g(float(score))}\n"
        )


def _cluster(positions, length, n_minhashes, ref_idx, minus, threshold, best, hits):
    """Greedy query-length windowing over sorted matched positions
    (findPerStrand, CommandFind.cpp:322-394), including its idiosyncratic
    index bookkeeping, reproduced step for step."""
    n = len(positions)
    ws_i = 0
    wc = 0
    j = 0
    while j < n:
        wc += 1
        # drop window start while it trails more than a query length behind
        while ws_i != j and positions[j] > length and positions[ws_i] < positions[j] - length + 1:
            ws_i += 1
            wc -= 1
        # extend the right edge while it stays within a query length
        while j != n and positions[j] - positions[ws_i] < length:
            wc += 1
            j += 1
        wc -= 1
        j -= 1
        score = np.float32(wc) / np.float32(n_minhashes)
        hit = (ref_idx, positions[ws_i], positions[j], minus, np.float32(score))
        if float(score) >= threshold and (
            best == 0 or len(hits) < best or _cpp_less(hit, max(hits, key=_worst_key))
        ):
            hits.append(hit)
            if best != 0 and len(hits) > best:
                hits.remove(max(hits, key=_worst_key))
        j += 1


class _worst_key:
    """Key object ordering hits so max() returns the priority-queue top
    (the worst hit under the reference's comparator)."""

    def __init__(self, hit):
        self.hit = hit

    def __lt__(self, other):
        return _cpp_less(self.hit, other.hit)


_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _rev_comp_acgt(b: bytes) -> bytes:
    """find's minus strand uses the 4-base complement only
    (CommandFind.cpp:252-268); other characters pass through."""
    return b.translate(_COMPLEMENT)[::-1]
