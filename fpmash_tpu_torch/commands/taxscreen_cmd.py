"""`taxscreen` — Kraken-style taxonomic report over screen results
(CommandTaxScreen.cpp:38-446).

Reference taxIDs come from a ``-m`` mapping file (``taxID<TAB>refName``
lines) or a ``taxid <N>`` token in each reference's comment; each shared
hash is assigned the LCA of the references containing it; counts roll up
the taxonomy and print as a Kraken report.  The pool files become one
record stream on ``--device`` (``models/sketch.record_stream``: a plain
file's bytes parsed there), whose k-mers are hashed
and counted on ``--device`` (``models/sketch.distinct_kmer_counts``, the
query side of ``screen``: K7 or K8, then the distinct values and their
counts).  Flags, defaults and output
bytes are those of ``python -m fpmash_tpu taxscreen``; ``--device`` replaces
``--backend``.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

import numpy as np

from fpmash_tpu_torch import device as placement
from fpmash_tpu_torch.commands.common import add_device_option
from fpmash_tpu_torch.device import to_host
from fpmash_tpu_torch.models.sketch import Sketch, distinct_kmer_counts, record_stream
from fpmash_tpu_torch.utils.taxdb import TaxCounts, TaxDB


def add_parser(sub):
    p = sub.add_parser(
        "taxscreen",
        help="Create Kraken-style taxonomic report based on mash screen.",
    )
    p.add_argument("queries", metavar="<queries>.msh")
    p.add_argument("pool", nargs="+", metavar="<pool>")
    p.add_argument("-m", "--mapping-file", default="", help="Mapping file from reference name to taxonomy ID.")
    p.add_argument("-t", "--taxonomy-dir", default=".", help="Directory containing NCBI taxonomy dump.")
    p.add_argument("-i", "--identity", type=float, default=0.0)
    p.add_argument("-v", "--pvalue", type=float, default=1.0)
    p.add_argument("-fp", "--fingerprint", action="store_true", help="Reference is a fingerprint .txt file.")
    add_device_option(p)
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    devices = placement.resolve_devices(args.device)
    names = os.path.join(args.taxonomy_dir, "names.dmp")
    nodes = os.path.join(args.taxonomy_dir, "nodes.dmp")
    if not (os.path.exists(names) and os.path.exists(nodes)):
        print(
            f"Could not find a file names.dmp or nodes.dmp in directory {args.taxonomy_dir}\n"
            " To download the required taxonomy files into the current directory, use the following commands:\n"
            "   wget ftp://ftp.ncbi.nih.gov/pub/taxonomy/taxdump.tar.gz\n"
            "   tar xvvf taxdump.tar.gz\n",
            file=sys.stderr,
        )
        return 1

    ref = Sketch()
    if args.fingerprint:
        ref.params = ref.params.for_fingerprint()
        ref.init_from_fingerprints([args.queries], device=devices[0])
    else:
        if not args.queries.endswith(".msh"):
            print(f"ERROR: {args.queries} does not look like a sketch (.msh)", file=sys.stderr)
            return 1
        ref.load_msh(args.queries)
    p = ref.params

    print("Loading taxonomy files ...", file=sys.stderr)
    taxdb = TaxDB(names, nodes)

    print("Reading mapping file ...", file=sys.stderr)
    ref_tax = [0] * len(ref.references)
    if args.mapping_file:
        mapping = {}
        with open(args.mapping_file) as fh:
            for line in fh:
                parts = line.rstrip("\n").split(None, 1)
                if len(parts) == 2:
                    mapping[parts[1]] = int(parts[0])
        for i, r in enumerate(ref.references):
            ref_tax[i] = mapping.get(r.name, 0)
    for i, r in enumerate(ref.references):
        if ref_tax[i] == 0:
            toks = r.comment.split()
            for j, t in enumerate(toks):
                if t == "taxid" and j + 1 < len(toks):
                    try:
                        ref_tax[i] = int(toks[j + 1])
                    except ValueError:
                        pass
        if ref_tax[i] == 0:
            print(
                f"Could not find taxID for reference {r.name} in comment field or mapping file!",
                file=sys.stderr,
            )

    # hash -> reference indices
    hash_table: dict[int, set[int]] = defaultdict(set)
    for i, r in enumerate(ref.references):
        for h in map(int, r.hashes):
            hash_table[h].add(i)
    print(f"   {len(hash_table)} distinct hashes.", file=sys.stderr)

    # stream pool k-mers
    stream, lengths = record_stream(args.pool, p.kmer_size, devices[0])
    if not (lengths >= p.kmer_size).any():
        print("\nERROR: Did not find sequence records in inputs", file=sys.stderr)
        return 1
    values, vcounts = distinct_kmer_counts(stream, lengths, p, devices)
    pool_count = dict(zip(to_host(values).view(np.uint64).tolist(), to_host(vcounts).tolist()))

    min_cov = 1
    counts: dict[int, TaxCounts] = defaultdict(TaxCounts)
    for h, idxs in hash_table.items():
        tax = 0
        for i in idxs:
            tax = taxdb.lca(ref_tax[i], tax)
        c = pool_count.get(h, 0)
        counts[tax].tax_hash_count += 1
        if c >= min_cov:
            counts[tax].tax_count += 1

    total_count = sum(tc.tax_count for tc in counts.values())
    total_hash_count = sum(tc.tax_hash_count for tc in counts.values())

    # roll up clades
    for tax_id in list(counts.keys()):
        tc = counts[tax_id]
        count, hash_count = tc.tax_count, tc.tax_hash_count
        for anc in taxdb.ancestors(tax_id):
            counts[anc].clade_count += count
            counts[anc].clade_hash_count += hash_count
            parent = taxdb.entries[anc].parent
            if parent is not None:
                kids = counts[parent].children
                if anc not in kids:
                    kids.append(anc)

    print("Writing output...", file=sys.stderr)
    taxdb.write_report(dict(counts), total_count, total_hash_count)
    return 0
