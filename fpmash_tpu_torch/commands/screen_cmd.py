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
same flags and output bytes; ``--device`` replaces ``--backend``.

The streaming path keeps the large sets on the device, where the JAX
package brings them to the host: the reference sketch is read as columns
(``utils/msh.read_columns``, no Python object a reference), its file's words
go up once, and the CSR array (every reference's hashes back to back, and
each one's count) is gathered from them there; it gives the distinct count of
the ``Loading`` line; the query files go up as their bytes and become one
record stream there (``models/sketch.record_stream``: the record-stream
kernel, ``csrc/seq_stream.cu``), whose k-mers are hashed (K7/K8) and
counted there, sorted (``models/sketch.distinct_kmer_counts``, which
``taxscreen`` shares); one ``searchsorted`` of every reference hash in the
query's distinct values gives the hits, and segment sums the shared counts.
Only the shared counts, the hits as (reference, query rank, multiplicity)
and the query's ``s`` smallest values come back; the ``-w`` reallocation
and the medians run on the hits.
Traced as ``screen-load``, ``screen-query``, ``screen-membership``,
``screen-winner`` and ``screen-lines`` (``utils/trace.py``), with counters.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.commands.common import (
    ALPHABET_PROTEIN,
    add_device_option,
    expand_inputs,
)
from fpmash_tpu_torch.device import to_device, to_host
from fpmash_tpu_torch.models.sketch import (
    Sketch,
    SketchParams,
    distinct_kmer_counts,
    record_stream,
    translated_stream,
)
from fpmash_tpu_torch.ops.bottomk import estimate_set_size
from fpmash_tpu_torch.ops.murmur3 import flip_sign
from fpmash_tpu_torch.scalar.stats import format_g, screen_pvalue
from fpmash_tpu_torch.utils.msh import MshColumns, read_columns
from fpmash_tpu_torch.utils.trace import count, trace


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


@dataclass
class _Table:
    """The reference sketch's hashes in CSR form: every reference's hashes
    back to back on the device (``keys``, sign-flipped so that signed order
    is unsigned order), each reference's count of them (``seg_len``) and its
    length (``lengths``)."""

    seg_len: np.ndarray
    lengths: np.ndarray
    keys: torch.Tensor

    @classmethod
    def of(cls, db: MshColumns, p, device) -> "_Table":
        """The table of ``db`` under the adopted parameters ``p``: the hash
        lists of ``p``'s width, each cut to ``p.sketch_size`` as loading a
        sketch cuts it (Sketch.cpp:1117-1120), gathered on ``device`` from
        the file's words."""
        first, n, dtype = db.elements("hashes64" if p.use64 else "hashes32")
        seg_len = np.minimum(n, p.sketch_size)
        total = int(seg_len.sum())
        words = to_device(db.words, device)
        elems = words if dtype == np.uint64 else words.view(torch.int32)
        # each key's element: its reference's first element plus its rank there
        idx = torch.arange(total, device=words.device)
        idx += torch.repeat_interleave(to_device(first - (np.cumsum(seg_len) - seg_len), device),
                                       to_device(seg_len, device), output_size=total)
        keys = elems[idx]
        if dtype == np.uint32:
            keys = keys.to(torch.int64) & 0xFFFFFFFF
        return cls(seg_len, db.lengths.view(np.int64), flip_sign(keys))

    def cat(self) -> np.ndarray:
        """The hashes back to back, on the host."""
        return to_host(flip_sign(self.keys)).view(np.uint64)

    def distinct(self) -> int:
        """The number of distinct hashes, counted where the keys are."""
        return int(torch.unique(self.keys).numel())


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    # The reference builds a hash -> {reference indices} table here
    # (CommandScreen.cpp:81-102).  At its target scale (a RefSeq sketch of
    # 54 118 references) a per-hash loop dominates the whole command, so the
    # table is kept in CSR form on the device instead (_Table), dissolved
    # into sorted-array operations.
    with trace("screen-load", file=args.reference):
        db = read_columns(args.reference)
        p = SketchParams().adopting(db.header)
        table = _Table.of(db, p, devices[0])
        set_size = table.distinct()
        count("references", len(db))
        count("ref_hashes", table.keys.numel())
        count("bytes", os.path.getsize(args.reference))
        count("ref_objects", db.objects)
    print(f"Loading {args.reference}...", file=sys.stderr)
    print(f"   {set_size} distinct hashes.", file=sys.stderr)

    if args.fingerprint:
        # the fork's rewrite uses the reference table size as setSize
        return _run_fp_query(args, p, table, set_size, devices[0])
    return _run_streaming(args, db, p, table, devices)


def _query_counts(args, p, devices):
    """The query files' distinct k-mer hashes, ascending as unsigned, and
    their multiplicities, on ``devices[0]`` (``int64``)."""
    paths = expand_inputs(args.queries, False)
    if p.alphabet == ALPHABET_PROTEIN:
        # amino-acid sketch + nucleotide mixture: 6-frame translate each
        # mixture sequence
        print("Translating from nucleotides...", file=sys.stderr)
        stream, lengths = translated_stream(paths, p)
    else:
        stream, lengths = record_stream(paths, p.kmer_size, devices[0])
    count("bases", int(lengths.sum()))
    count("records", len(lengths))
    values, counts = distinct_kmer_counts(stream, lengths, p, devices)
    count("query_distinct", values.numel())
    return values, counts


def _membership(table: _Table, values: torch.Tensor, counts: torch.Tensor, s: int):
    """Every reference hash searched among the query's distinct ``values``
    (ascending as unsigned) on their device.  Returns, on the host, the
    shared count of each reference, the hits as (reference, query rank,
    multiplicity) in reference order, and the query's ``s`` smallest
    values."""
    keys = flip_sign(values)
    n, d = table.keys.numel(), keys.numel()
    count("ref_hashes", n)
    count("query_distinct", d)
    seg_len = torch.as_tensor(table.seg_len, device=keys.device)
    if n and d:
        idx = torch.searchsorted(keys, table.keys).clamp_(max=d - 1)
        hit = keys[idx] == table.keys
        csum = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
        torch.cumsum(hit, 0, out=csum[1:])
        ends = torch.cumsum(seg_len, 0)
        shared = csum[ends] - csum[ends - seg_len]
        occ = hit.nonzero().flatten()
        rid = torch.searchsorted(ends, occ, right=True)
        rank = idx[occ]
        hits = torch.stack([rid, rank, counts[rank]])
    else:
        shared = torch.zeros(len(table.seg_len), dtype=torch.int64, device=keys.device)
        hits = torch.zeros((3, 0), dtype=torch.int64, device=keys.device)
    count("hits", hits.shape[1])
    rid, rank, depth = to_host(hits)
    return to_host(shared), rid, rank, depth, to_host(values[:s]).view(np.uint64)


def _medians(rid: np.ndarray, depth: np.ndarray, shared: np.ndarray) -> np.ndarray:
    """Each reference's median multiplicity: the ``shared // 2``-th of its
    hits' multiplicities in ascending order (0 where it has none), the hits
    given as the references ``rid`` and multiplicities ``depth``."""
    order = np.lexsort((depth, rid))
    starts = np.cumsum(shared) - shared
    medians = np.zeros(len(shared), np.int64)
    nz = shared > 0
    medians[nz] = depth[order][(starts + shared // 2)[nz]]
    return medians


def _winners(rid, rank, depth, shared, table: _Table, k: int):
    """Winner-takes-all reallocation (CommandScreen.cpp:152-200): every
    distinct reference hash seen in the query stream is credited to the
    single reference with the best pre-reallocation score (ties: greater
    length; the reference's residual tie-break is its hash container's
    iteration order, i.e. unspecified — pinned here to the lowest reference
    index).  Returns each winner and the multiplicity of its hash."""
    scores = np.zeros(len(shared))
    for i in np.unique(rid).tolist():
        scores[i] = estimate_identity(int(shared[i]), int(table.seg_len[i]), k)
    # ascending lexsort, query rank primary: the last row of each rank has
    # max score, then max length, then min reference index
    order = np.lexsort((-rid, table.lengths[rid], scores[rid], rank))
    rank_o, rid_o = rank[order], rid[order]
    last = np.nonzero(np.diff(rank_o, append=-1))[0] if len(rank_o) else np.zeros(0, np.int64)
    return rid_o[last], depth[order][last]


def _run_streaming(args, db: MshColumns, p, table: _Table, devices) -> int:
    """Upstream semantics: stream all query k-mers; report per reference."""
    with trace("screen-query"):
        values, counts = _query_counts(args, p, devices)
    with trace("screen-membership"):
        shared, rid, rank, depth, smallest = _membership(table, values, counts, p.sketch_size)
    # Upstream's p-value uses the *query stream's* cardinality estimate as
    # setSize (the same estimateSetSize that reads-mode sketches store as
    # their length; MinHashHeap.h:45) — verified against the golden, whose
    # implied setSize is exactly the reads sketch length 502359.
    set_size = int(estimate_set_size(smallest, p.sketch_size, 64 if p.use64 else 32))
    # `-s` saturation (CommandScreen.cpp:43, :147, :241-245): the fork's
    # live code pushes a literal 0 per shared-hash hit during counting (the
    # upstream streaming k-mer totals no longer exist in the rewrite), and
    # the lists are NOT rebuilt by the -w reallocation — so the field is
    # `shared[i]` (pre-reallocation) comma-separated zeros.
    sat_counts = shared if args.saturation else None
    if args.winner:
        print("Reallocating to winners...", file=sys.stderr)
        with trace("screen-winner"):
            count("hits", len(rid))
            rid, depth = _winners(rid, rank, depth, shared, table, p.kmer_size)
            shared = np.bincount(rid, minlength=len(shared)).astype(np.int64)
            count("winners", int(np.count_nonzero(shared)))
    medians = _medians(rid, depth, shared)

    print("Writing output...", file=sys.stderr)
    with trace("screen-lines"):
        # a reference that shares nothing prints only under a negative -i
        shown = np.arange(len(shared)) if args.identity < 0.0 else np.flatnonzero(shared)
        lines = 0
        for i in shown.tolist():
            common, denom = int(shared[i]), int(table.seg_len[i])
            identity = estimate_identity(common, denom, p.kmer_size)
            if identity < args.identity:
                continue
            pv = screen_pvalue(common, set_size, p.kmer_space, denom)
            if pv > args.pvalue:
                continue
            line = (
                f"{format_g(identity)}\t{common}/{denom}\t{int(medians[i])}\t{format_g(pv)}"
                f"\t{db.text('name', i)}\t{db.text('comment', i)}"
            )
            if sat_counts is not None:
                line += "\t" + ",".join(["0"] * int(sat_counts[i]))
            sys.stdout.write(line + "\n")
            lines += 1
        count("lines", lines)
    return 0


def _run_fp_query(args, p, table: _Table, set_size, device) -> int:
    """The fork's sketch-based query path (-fp): one line per query
    reference (CommandScreen.cpp:116-257).

    Membership of every query hash in the reference universe is ONE
    searchsorted of the concatenated (CSR) query hash arrays against the
    sorted distinct reference values + a segmented reduction — no
    per-query/per-hash Python loop (same scaling treatment as the
    streaming path; CommandScreen.cpp:81-102 builds a hash table for
    exactly this reason).
    """
    qry = Sketch(p)
    qry.init_from_fingerprints(expand_inputs(args.queries, False), device=device)

    universe = np.unique(table.cat())
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
