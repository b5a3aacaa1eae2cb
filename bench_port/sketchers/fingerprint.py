"""fp-mash's fingerprint sketch of each input (``reference/fingerprint.py``):
one entry a read, its windows' hashes in order.  The reads of all the inputs
asked for are factorized together, so the card takes them at once.  As the
control, one precision down: factor lengths hashed as 32-bit words where
fp-mash hashes 64-bit ones."""

from bench_port.harness.check import Want
from bench_port.reference import fingerprint as ref_fp


def entries(items, cfg: dict, expect: dict, device, control: bool) -> list[list[Want]]:
    records = [(h, s.tobytes().decode("ascii")) for item in items
               for h, s in zip(item.headers, item.seqs)]
    for item in items:
        if ref_fp.window_count(item.seqs) > ref_fp.LINE_CAP:
            raise ValueError(f"{item.path}: over the line cap, which the reference does not model")
    found = ref_fp.fp_sketch(records, expect["factorization"], device, cfg["hash_seed"],
                             cfg["hash_bits"], element_bytes=4 if control else 8)
    out, pos = [], 0
    for item in items:
        out.append([Want(e.name, e.comment, e.length, e.hashes, None, e.factors)
                    for e in found[pos : pos + len(item.headers)]])
        pos += len(item.headers)
    return out
