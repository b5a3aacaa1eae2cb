"""Genome assemblies: ``pool`` genomes of ``length`` bases, one FASTA record
each, in families of ``family_size`` that share a random ancestor of GC
content drawn from ``gc``, each member ``divergence`` (drawn from the range)
substituted away from it.  A job takes ``inputs_per_job`` of them."""

from bench_port.harness.traffic import Item, Pool, bases, fasta_bytes, substitute


def make(rng, out, p: dict) -> Pool:
    items = []
    lo, hi = p["divergence"]
    for f in range(p["pool"] // p["family_size"]):
        gc = float(rng.uniform(*p["gc"]))
        ancestor = bases(rng, p["length"], gc)
        for _ in range(p["family_size"]):
            i = len(items)
            div = float(rng.uniform(lo, hi))
            seq = substitute(rng, ancestor, div)
            header = f"asm{i:03d} family={f} gc={gc:.4f} divergence={div:.4f}"
            path = out / f"asm{i:03d}.fna"
            path.write_bytes(fasta_bytes(header, seq, p["line_width"]))
            items.append(Item(path, [header], [seq], len(seq)))
    return Pool(items, p["inputs_per_job"])
