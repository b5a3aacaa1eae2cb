"""NCBI taxonomy database — names.dmp/nodes.dmp loader, LCA, Kraken report
(copy of :mod:`fpmash_tpu.utils.taxdb`).

Python rebuild of ``mash/src/mash/taxdb.hpp`` (TaxDB / TaxCounts /
writeReport) with the same report format:
``%.4f  cladeCount  taxCount  cladeHashCount  taxHashCount  rank  taxID
<2*depth spaces>name``, children ordered by descending cladeCount.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class TaxEntry:
    tax_id: int
    rank: str = ""
    name: str = ""
    parent: int | None = None


@dataclass
class TaxCounts:
    clade_count: int = 0
    tax_count: int = 0
    tax_hash_count: int = 0
    clade_hash_count: int = 0
    children: list[int] = field(default_factory=list)


class TaxDB:
    def __init__(self, names_dump: str, nodes_dump: str):
        self.entries: dict[int, TaxEntry] = {}
        self._parse_nodes(nodes_dump)
        self._parse_names(names_dump)

    def _parse_nodes(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 3:
                    continue
                tax_id = int(parts[0])
                parent = int(parts[1])
                rank = parts[2]
                self.entries[tax_id] = TaxEntry(tax_id, rank=rank, parent=parent)
        # the root (taxID 1) is its own parent in the dump; null it like
        # taxdb.hpp:95-100
        if 1 in self.entries:
            self.entries[1].parent = None

    def _parse_names(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 4:
                    continue
                if parts[3] == "scientific name" and int(parts[0]) in self.entries:
                    self.entries[int(parts[0])].name = parts[1]

    def ancestors(self, tax_id: int) -> list[int]:
        chain = []
        seen = set()
        cur = tax_id
        while cur is not None and cur in self.entries and cur not in seen:
            chain.append(cur)
            seen.add(cur)
            cur = self.entries[cur].parent
        return chain

    def lca(self, a: int, b: int) -> int:
        """Lowest common ancestor; 0/unknown IDs are ignored
        (taxdb.hpp getLowestCommonAncestor)."""
        if a == 0 or a not in self.entries:
            if a:
                print(f"TaxID {a} not in database - ignoring it.", file=sys.stderr)
            return b
        if b == 0 or b not in self.entries:
            if b:
                print(f"TaxID {b} not in database - ignoring it.", file=sys.stderr)
            return a
        aa = set(self.ancestors(a))
        for t in self.ancestors(b):
            if t in aa:
                return t
        return 1

    def write_report(self, counts: dict[int, TaxCounts], total_counts: int,
                     total_hash_counts: int, fh=None) -> None:
        fh = fh or sys.stdout
        fh.write("%\thashes\ttaxHashes\thashesDB\ttaxHashesDB\ttaxID\trank\tname\n")
        unclassified = counts.get(0)
        if unclassified and unclassified.clade_count > 0:
            fh.write(
                f"{100 * unclassified.clade_count / total_counts:.4f}\t"
                f"{unclassified.clade_count}\t{unclassified.tax_count}\tno rank\t0\tunclassified\n"
            )
        self._write_node(counts, total_counts, total_hash_counts, 1, 0, fh)

    def _write_node(self, counts, total_counts, total_hash_counts, tax_id, depth, fh):
        tc = counts.get(tax_id)
        if tc is None or tc.clade_count == 0:
            return
        taxon = self.entries.get(tax_id)
        rank = taxon.rank if taxon else "no rank"
        name = taxon.name if taxon else "?"
        pct = 100 * tc.clade_count / total_counts if total_counts else 0.0
        fh.write(
            f"{pct:.4f}\t{tc.clade_count}\t{tc.tax_count}\t{tc.clade_hash_count}\t"
            f"{tc.tax_hash_count}\t{rank}\t{tax_id}\t{'  ' * depth}{name}\n"
        )
        children = sorted(
            (c for c in tc.children if c in counts),
            key=lambda c: -counts[c].clade_count,
        )
        for child in children:
            self._write_node(counts, total_counts, total_hash_counts, child, depth + 1, fh)
