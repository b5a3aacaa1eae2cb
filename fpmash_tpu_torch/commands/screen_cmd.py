"""`fpmash screen` — containment of references within a read set
(CommandScreen.cpp:40-257).

Two query semantics exist in the lineage of the reference:

* **streaming** (upstream Mash, and what the checked-in golden
  ``test/ref/screen_ref.txt`` was produced by): every k-mer of the query
  files is hashed and membership-tested against the reference sketch's hash
  universe; one output line per *reference* with
  ``identity  shared/denom  median-multiplicity  p-value  name  comment``.
* **sketch-based** (the fork's rewrite): the query is itself sketched
  (``-fp`` -> initFromFingerprints), shared counts are per *query*
  (CommandScreen.cpp:116-151).  The rewrite also stopped incrementing
  ``hashCounts`` so its median column always prints 0 (author TODO at
  CommandScreen.cpp:206); we keep real counts instead, matching the golden.

This command uses streaming semantics for sequence queries (golden parity)
and sketch-based semantics for ``-fp`` fingerprint queries (the only mode
the rewrite adds).  Copy of ``fpmash_tpu/commands/screen_cmd.py`` with the
same flags and output bytes; ``--device`` replaces ``--backend``.  The query
k-mers are hashed and counted on the device (kernels K7/K8, then one
``torch.unique``), and only the distinct values and counts come back; the
set operations after that stay on the host, as in the JAX package.
"""

from __future__ import annotations

import sys

import numpy as np

from fpmash_tpu_torch.commands.common import (
    ALPHABET_PROTEIN,
    add_device_option,
    device_and_mesh,
    expand_inputs,
)
from fpmash_tpu_torch.models.sketch import Sketch, _kmer_distinct_counts
from fpmash_tpu_torch.scalar.stats import format_g, screen_pvalue


def add_parser(sub):
    p = sub.add_parser(
        "screen",
        help="Determine whether query sequences are within a larger mixture of sequences.",
    )
    p.add_argument("reference", metavar="<sketch>")
    p.add_argument("queries", nargs="+", metavar="<query>")
    p.add_argument("-w", "--winner", action="store_true", help="Winner-takes-all strategy for identity estimates.")
    p.add_argument("-s", "--saturation", action="store_true", help="Include saturation curve in output. Each line will have an additional field representing the absolute number of k-mers seen at each Jaccard increase, formatted as a comma-separated list.")
    p.add_argument("-i", "--identity", type=float, default=0.0, help="Minimum identity to report. [0]")
    p.add_argument("-v", "--pvalue", type=float, default=1.0, help="Maximum p-value to report. [1.0]")
    p.add_argument("-fp", "--fingerprint", action="store_true", help="Query files are fingerprint .txt files.")
    p.add_argument("-p", "--threads", type=int, default=1, help="Parallelism (interface parity).")
    add_device_option(p)
    # NOTE: screen does not take the shared sketch options in the reference
    # either — parameters are inherited from the reference sketch
    # (CommandScreen.cpp:66-78).
    p.set_defaults(func=run)
    return p


def estimate_identity(common: int, denom: int, kmer_size: int) -> float:
    """identity = jaccard^(1/k) (CommandScreen.cpp:259-278)."""
    if denom == 0 or common == 0:
        return 0.0
    if common == denom:
        return 1.0
    return (common / denom) ** (1.0 / kmer_size)


def run(args) -> int:
    device, mesh = device_and_mesh(args.device)
    ref = Sketch()
    ref.load_msh(args.reference)

    # The reference builds a hash -> {reference indices} table here
    # (CommandScreen.cpp:81-102).  At its target scale (a 100k-reference
    # RefSeq sketch) a per-hash Python dict loop dominates the whole
    # command, so the table is kept in CSR form instead: concatenated hash
    # arrays + per-hash reference ids, dissolved into sorted-array ops.
    n_refs = len(ref.references)
    seg_len = np.array([len(r.hashes) for r in ref.references], np.int64)
    cat = (
        np.concatenate([np.asarray(r.hashes, np.uint64) for r in ref.references])
        if n_refs
        else np.zeros(0, np.uint64)
    )
    set_size = len(np.unique(cat))
    print(f"Loading {args.reference}...", file=sys.stderr)
    print(f"   {set_size} distinct hashes.", file=sys.stderr)

    if args.fingerprint:
        # the fork's rewrite uses the reference table size as setSize
        return _run_fp_query(args, ref, set_size, device)
    return _run_streaming(args, ref, cat, seg_len, device, mesh)


def _run_streaming(args, ref: Sketch, cat: np.ndarray, seg_len: np.ndarray, device,
                   mesh) -> int:
    """Upstream semantics: stream all query k-mers; report per reference."""
    from fpmash_tpu_torch.ops.bottomk import estimate_set_size
    from fpmash_tpu_torch.utils.fasta import read_sequences

    p = ref.params
    # amino-acid sketch + nucleotide mixture: 6-frame translate each
    # mixture sequence (upstream screen; hashSequence CommandScreen.cpp:311-376)
    trans = p.alphabet == ALPHABET_PROTEIN
    if trans:
        print("Translating from nucleotides...", file=sys.stderr)

    seqs = []
    for path in expand_inputs(args.queries, False):
        for rec in read_sequences(path):
            if len(rec.seq) >= p.kmer_size:
                if trans:
                    from fpmash_tpu_torch.utils.codon import six_frame_translations

                    seqs.extend(six_frame_translations(rec.seq, p.preserve_case))
                else:
                    seqs.append(rec.seq)
    # distinct query-hash values + multiplicities, computed on the device:
    # only they come down, never the 8 B/base pool (CommandScreen.cpp:81-151
    # scale rationale)
    values, counts = _kmer_distinct_counts(seqs, p, device, mesh)

    # Upstream's p-value uses the *query stream's* cardinality estimate as
    # setSize (the same estimateSetSize that reads-mode sketches store as
    # their length; MinHashHeap.h:45) — verified against the golden, whose
    # implied setSize is exactly the reads sketch length 502359.
    bits = 64 if p.use64 else 32
    set_size = int(estimate_set_size(values, p.sketch_size, bits))
    # membership of each reference's hashes in the query hash multiset:
    # ONE searchsorted of all reference hash arrays concatenated (CSR)
    # against the sorted distinct query values, then a segmented reduction
    # — no per-reference Python loop (the reference builds a hash table for
    # exactly this scale reason, CommandScreen.cpp:81-102; a 100k-reference
    # RefSeq sketch is the target workload)
    n_refs = len(ref.references)
    ends = np.cumsum(seg_len)
    if len(values) and len(cat):
        idx = np.minimum(np.searchsorted(values, cat), len(values) - 1)
        present = values[idx] == cat
    else:
        idx = np.zeros(len(cat), np.int64)
        present = np.zeros(len(cat), bool)
    # per-segment shared counts via cumulative sums at segment ends
    csum = np.concatenate([[0], np.cumsum(present.astype(np.int64))])
    shared_ends = csum[ends]
    shared_starts = csum[ends - seg_len]
    shared = [int(s) for s in shared_ends - shared_starts]
    depth_cat = counts[idx[present]] if len(cat) else np.zeros(0, np.int64)
    depths = [
        [int(c) for c in depth_cat[a:b]] for a, b in zip(shared_starts, shared_ends)
    ]
    # `-s` saturation (CommandScreen.cpp:43, :147, :241-245): the fork's
    # live code pushes a literal 0 per shared-hash hit during counting (the
    # upstream streaming k-mer totals no longer exist in the rewrite), and
    # the lists are NOT rebuilt by the -w reallocation — so the field is
    # `shared[i]` (pre-reallocation) comma-separated zeros.
    sat_counts = list(shared) if args.saturation else None
    if args.winner:
        # Winner-takes-all reallocation (CommandScreen.cpp:152-200): every
        # distinct reference hash seen in the query stream is credited to
        # the single reference with the best pre-reallocation score (ties:
        # greater length; the reference's residual tie-break is its hash
        # container's iteration order, i.e. unspecified — pinned here to
        # the lowest reference index).  Segmented argmax over the CSR
        # arrays: no per-hash Python loop.
        print("Reallocating to winners...", file=sys.stderr)
        scores = np.array(
            [
                estimate_identity(shared[i], int(seg_len[i]), p.kmer_size)
                for i in range(n_refs)
            ]
        )
        lengths = np.array([r.length for r in ref.references], np.int64)
        ref_ids = np.repeat(np.arange(n_refs, dtype=np.int64), seg_len)
        occ = np.nonzero(present)[0]  # reference-hash occurrences in query
        grp = idx[occ]  # rank of the hash among the distinct query values
        rid = ref_ids[occ]
        # ascending lexsort, group primary: the last row of each group has
        # max score, then max length, then min reference index
        order = np.lexsort((-rid, lengths[rid], scores[rid], grp))
        grp_o, rid_o = grp[order], rid[order]
        last = (
            np.nonzero(np.diff(grp_o, append=-1))[0]
            if len(grp_o)
            else np.zeros(0, np.int64)
        )
        winners = rid_o[last]
        depth_vals = counts[grp_o[last]]
        shared_arr = np.bincount(winners, minlength=n_refs).astype(np.int64)
        # per-winner sorted depth lists -> medians, in one grouped lexsort
        dorder = np.lexsort((depth_vals, winners))
        w_sorted, d_sorted = winners[dorder], depth_vals[dorder]
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(w_sorted, minlength=n_refs))]
        )[:-1]
        medians = np.zeros(n_refs, np.int64)
        nz = shared_arr > 0
        medians[nz] = d_sorted[(starts + shared_arr // 2)[nz]]
        shared = [int(s) for s in shared_arr]
    else:
        medians = None

    print("Writing output...", file=sys.stderr)
    for i, r in enumerate(ref.references):
        denom = len(r.hashes)
        if shared[i] == 0 and args.identity >= 0.0:
            continue
        identity = estimate_identity(shared[i], denom, p.kmer_size)
        if identity < args.identity:
            continue
        pv = screen_pvalue(shared[i], set_size, p.kmer_space, denom)
        if pv > args.pvalue:
            continue
        if medians is not None:
            med = int(medians[i]) if shared[i] > 0 else 0
        else:
            med = sorted(depths[i])[shared[i] // 2] if shared[i] > 0 else 0
        line = (
            f"{format_g(identity)}\t{shared[i]}/{denom}\t{med}\t{format_g(pv)}"
            f"\t{r.name}\t{r.comment}"
        )
        if sat_counts is not None:
            line += "\t" + ",".join(["0"] * sat_counts[i])
        sys.stdout.write(line + "\n")
    return 0


def _run_fp_query(args, ref: Sketch, set_size, device) -> int:
    """The fork's sketch-based query path (-fp): one line per query
    reference (CommandScreen.cpp:116-257).

    Membership of every query hash in the reference universe is ONE
    searchsorted of the concatenated (CSR) query hash arrays against the
    sorted distinct reference values + a segmented reduction — no
    per-query/per-hash Python loop (same scaling treatment as the
    streaming path; CommandScreen.cpp:81-102 builds a hash table for
    exactly this reason).
    """
    p = ref.params
    qry = Sketch(p)
    qry.init_from_fingerprints(expand_inputs(args.queries, False), device=device)

    universe = np.unique(
        np.concatenate(
            [np.asarray(r.hashes, np.uint64) for r in ref.references]
            or [np.zeros(0, np.uint64)]
        )
    )
    seg_len = np.array([len(q.hashes) for q in qry.references], np.int64)
    ends = np.cumsum(seg_len)
    cat = (
        np.concatenate([np.asarray(q.hashes, np.uint64) for q in qry.references])
        if len(qry.references)
        else np.zeros(0, np.uint64)
    )
    if len(universe) and len(cat):
        idx = np.minimum(np.searchsorted(universe, cat), len(universe) - 1)
        present = universe[idx] == cat
    else:
        present = np.zeros(len(cat), bool)
    csum = np.concatenate([[0], np.cumsum(present.astype(np.int64))])
    shared_per_q = csum[ends] - csum[ends - seg_len]

    for qi, q in enumerate(qry.references):
        shared = int(shared_per_q[qi])
        if shared == 0 and args.identity >= 0.0:
            continue
        denom = int(seg_len[qi])
        identity = estimate_identity(shared, denom, p.kmer_size)
        if identity < args.identity:
            continue
        pv = screen_pvalue(shared, set_size, p.kmer_space, denom)
        if pv > args.pvalue:
            continue
        # median of the running per-hash repeat index (the fork counts each
        # shared occurrence's multiplicity-so-far): for occurrence counts
        # c_1..c_m of the distinct shared values, the depth list is
        # 1..c_1, 1..c_2, ... — reproduce from the segment's present hashes
        seg = cat[ends[qi] - seg_len[qi] : ends[qi]]
        seg = seg[present[ends[qi] - seg_len[qi] : ends[qi]]]
        # sorted depth list for occurrence counts c_1..c_m is the multiset
        # ∪_j {1..c_j}; its t-th level has #{j : c_j >= t} entries, so the
        # median falls at the first level whose cumulative size exceeds
        # shared // 2 — no per-hash Python loop
        if shared:
            cnt_u = np.unique(seg, return_counts=True)[1]
            per_level = (cnt_u[None, :] >= np.arange(1, cnt_u.max() + 1)[:, None]).sum(1)
            med = 1 + int(np.searchsorted(np.cumsum(per_level), shared // 2 + 1))
        else:
            med = 0
        line = (
            f"{format_g(identity)}\t{shared}/{denom}\t{med}\t{format_g(pv)}"
            f"\t{q.name}\t{q.comment}"
        )
        if args.saturation:
            # one 0 per shared hit (CommandScreen.cpp:147, :241-245)
            line += "\t" + ",".join(["0"] * shared)
        sys.stdout.write(line + "\n")
    return 0
