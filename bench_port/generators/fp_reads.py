"""fp-mash's read batches: ``pool`` FASTA files of ``reads`` reads of
``read_length`` bases at GC content ``gc``, headed ``>T.. G..`` as lyn2vec's
transcripts are.  A job takes ``inputs_per_job`` files (default one)."""

from bench_port.harness.traffic import Item, Pool, bases, fasta_bytes


def make(rng, out, p: dict) -> Pool:
    items = []
    for i in range(p["pool"]):
        reads = bases(rng, p["reads"] * p["read_length"], p["gc"]).reshape(p["reads"], -1)
        headers = [f"T{i:03d}{r:07d} G{i:03d}{r:07d}" for r in range(p["reads"])]
        path = out / f"reads{i:03d}.fasta"
        path.write_bytes(b"".join(fasta_bytes(h, s, p["line_width"])
                                  for h, s in zip(headers, reads)))
        items.append(Item(path, headers, list(reads), reads.size))
    return Pool(items, p.get("inputs_per_job", 1))
