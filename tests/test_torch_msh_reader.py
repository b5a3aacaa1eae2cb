"""Port: the `.msh` reader decodes the file as columns and gives the same
``MshFile`` as the JAX package's reader, which walks the file one reference
at a time (``fpmash_tpu.utils.msh.read_msh``).  Each case is one file: every golden
``.msh`` (Mash's own, with 2 and 4 segments and far pointers), files of the
port's writer (32-bit hashes with counts, empty texts and lists, the
``referenceList`` slot of a seed other than 42, loci), a single-segment
database of the benchmark's plain writer, and a writer's file whose lists
were moved to other segments behind single-far and double-far pointers.
"""

import numpy as np
import pytest

from bench_port.reference.msh_writer import msh_bytes
from fpmash_tpu.utils import msh as jax_msh
from fpmash_tpu_torch.utils import msh

GOLDEN = ["cfl/DNA1-sketch.msh", "cfl/DNA2-sketch.msh", "cfl/DNA3-sketch.msh",
          "mash_ref/genome1.fna.msh", "mash_ref/genome2.fna.msh", "mash_ref/genome3.fna.msh",
          "new_data/genomes.msh", "new_data/reads.msh"]


def _reference_list(r: jax_msh._Reader):
    """(first element's word, count, data words, pointer words) of the
    reference list of a file whose lists sit in segment 0, ``referenceList``
    when it has content, else ``referenceListOld``, as ``read_msh`` takes it."""
    _, start, dw, pw = r.struct_at(0, 0)
    for slot in (3, 0):
        st = r.struct_at(0, start + dw + slot) if slot < pw else None
        if st is not None:
            lseg, lstart, ldw, _ = st
            _, estart, _, n, tag = r.list_at(lseg, lstart + ldw)
            if n:
                return estart, n, (tag >> 32) & 0xFFFF, (tag >> 48) & 0xFFFF
    raise ValueError("no references")


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------

RNG = np.random.default_rng(22)


def _u32(n):
    return np.sort(RNG.integers(0, 2**32, n, dtype=np.uint64)).astype(np.uint32)


def _u64(n):
    return np.sort(RNG.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True))


def _written(path, **fields):
    refs = [msh.MshReference(**r) for r in fields.pop("references")]
    msh.write_msh(str(path), msh.MshFile(references=refs, **fields))


def _far(path, double: bool):
    """The single-segment file at ``path`` with every reference's texts, hashes
    and counts moved behind far pointers: after one landing pad each in a
    second segment (single-far), or into a third segment with a pad of a far
    pointer and a tag in the second (double-far)."""
    r = jax_msh._Reader(path.read_bytes())
    assert len(r.segments) == 1
    seg0 = np.frombuffer(r.segments[0], np.uint64).copy()
    estart, n, edw, epw = _reference_list(r)

    def far(offset, seg, dbl):
        return 2 | dbl << 2 | offset << 3 | seg << 32

    pads, content = [], []
    for i in range(n):
        for slot in range(2, epw):
            at = estart + i * (edw + epw) + edw + slot
            w = int(seg0[at])
            if not w:
                continue
            esize, count = (w >> 32) & 7, w >> 35
            target = at + 1 + jax_msh._ptr_parts(w)[1]
            body = seg0[target : target + {2: (count + 7) // 8, 4: (count + 1) // 2,
                                           5: count}[esize]].tolist()
            here = w & 0xFFFFFFFF00000003  # the same list, its content right after
            if double:
                pads += [far(len(content), 2, 0), here]
                content += body
                seg0[at] = far(len(pads) - 2, 1, 1)
            else:
                seg0[at] = far(len(pads), 1, 0)
                pads += [here] + body
    segments = [seg0, np.array(pads, np.uint64)] + ([np.array(content, np.uint64)]
                                                    if double else [])
    head = np.array([len(segments) - 1] + [len(s) for s in segments], np.uint32)
    head = np.append(head, np.zeros(len(head) % 2, np.uint32))
    out = path.with_name(path.stem + ("_double" if double else "_single") + ".msh")
    out.write_bytes(head.tobytes() + b"".join(s.tobytes() for s in segments))
    return out


def _case(name, tmp_path, golden_dir):
    if name.startswith("golden:"):
        return golden_dir / name.split(":", 1)[1]
    path = tmp_path / f"{name}.msh"
    if name == "u32_counts":
        _written(path, kmer_size=15, references=[
            dict(name="reads", comment="", length=77, hashes32=_u32(7),
                 counts32=np.arange(1, 8, dtype=np.uint32), counts32_sorted=True),
            dict(name="odd", comment="c", length=2**33, hashes32=_u32(11),
                 counts32=RNG.integers(1, 9, 11, dtype=np.uint32)),
            dict(name="none", comment="x", length=5, hashes32=_u32(4))])
    elif name == "empty_texts_and_lists":
        _written(path, references=[
            dict(name="", comment="", length=0),
            dict(name="", comment=None, length=1, hashes64=np.zeros(0, np.uint64),
                 counts32=np.zeros(0, np.uint32)),
            dict(name=None, comment="", length=2, hashes64=_u64(3)),
            dict(name="séquence 🧬", comment="Ω\r", length=3, hashes32=np.zeros(0, np.uint32))])
    elif name == "reference_list_seed7":
        _written(path, hash_seed=7, kmer_size=1, alphabet="0123456789", references=[
            dict(name=f"r{i}", comment="c", length=100 + i, hashes32=_u32(5 + i))
            for i in range(4)])
    elif name == "loci":
        _written(path, kmer_size=15, window_size=1000, min_hashes_per_window=10,
                 concatenated=False, references=[
                     dict(name="chr", comment="", length=5000, hashes64=_u64(4))],
                 loci=[(0, 0, 2**64 - 1), (0, 4999, 17), (0, 2**32 - 1, 0)])
    elif name.startswith("plain_writer"):
        n, seed = 200, (42 if name == "plain_writer" else 1234567)
        seg_len = RNG.integers(0, 40, n)
        path.write_bytes(msh_bytes(
            kmer=21, sketch_size=1000, seed=seed, alphabet="ACGT", canonical=True,
            names=[f"GCF_{i:09d}.1" for i in range(n)],
            comments=[f"[1 seqs] genome {i} [...]" if i % 3 else "" for i in range(n)],
            lengths=RNG.integers(1, 2**40, n), hashes=_u64(int(seg_len.sum())),
            seg_len=seg_len))
    elif name == "length32":  # Mash's older files: the u32 length, length64 0
        _written(path, references=[dict(name=f"r{i}", comment="", length=7 + i,
                                        hashes64=_u64(2)) for i in range(4)])
        words = np.frombuffer(path.read_bytes(), np.uint64).copy()
        estart, n, edw, epw = _reference_list(jax_msh._Reader(words.tobytes()))
        for i in range(0, n, 2):
            at = 1 + estart + i * (edw + epw)  # after the stream header's word
            words[at] |= words[at + 1]
            words[at + 1] = 0
        path.write_bytes(words.tobytes())
    elif name.startswith("far_"):
        _written(path, references=[
            dict(name=f"r{i}", comment="c" * i, length=1000 + i, hashes64=_u64(3 + i),
                 counts32=RNG.integers(1, 9, 3 + i, dtype=np.uint32)) for i in range(5)]
                 + [dict(name="empty", comment="", length=1)])
        return _far(path, name == "far_double")
    else:
        raise KeyError(name)
    return path


CASES = ["golden:" + g for g in GOLDEN] + [
    "u32_counts", "empty_texts_and_lists", "reference_list_seed7", "loci", "length32",
    "plain_writer",
    "plain_writer_seed", "far_single", "far_double"]


def _same(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", CASES)
def test_read_msh_gives_the_jax_readers_file(case, tmp_path, golden_dir):
    path = _case(case, tmp_path, golden_dir)
    want, got = jax_msh.read_msh(str(path)), msh.read_msh(str(path))
    for attr in ("kmer_size", "window_size", "min_hashes_per_window", "concatenated", "error",
                 "noncanonical", "alphabet", "preserve_case", "hash_seed", "loci"):
        assert _same(getattr(got, attr), getattr(want, attr)), attr
    assert len(got.references) == len(want.references)
    for g, w in zip(got.references, want.references):
        for attr in ("name", "comment", "length", "hashes32", "hashes64", "counts32",
                     "counts32_sorted"):
            assert _same(getattr(g, attr), getattr(w, attr)), attr
    if case.startswith("far_"):  # the same references as before their lists moved
        before = jax_msh.read_msh(str(tmp_path / f"{case}.msh")).references
        assert len(before) == len(got.references)
        for g, b in zip(got.references, before):
            for attr in ("name", "comment", "length", "hashes64", "counts32"):
                assert _same(getattr(g, attr), getattr(b, attr)), attr


@pytest.mark.parametrize("case", CASES)
def test_columns_hold_every_reference_without_an_object(case, tmp_path, golden_dir):
    """The columns give each reference's texts and lists where the JAX reader finds
    them, and building them makes no ``MshReference``."""
    path = _case(case, tmp_path, golden_dir)
    want = jax_msh.read_msh(str(path))
    db = msh.read_columns(str(path))
    assert db.objects == 0 and len(db) == len(want.references)
    assert db.header.references == [] and db.header.loci == want.loci
    assert db.lengths.dtype == np.uint64
    assert db.lengths.tolist() == [r.length for r in want.references]
    assert db.counts32_sorted.tolist() == [r.counts32_sorted for r in want.references]
    for name, dtype in (("hashes32", np.uint32), ("hashes64", np.uint64)):
        first, n, got_dtype = db.elements(name)
        assert got_dtype is dtype
        view = db.words.view(dtype)
        for i, r in enumerate(want.references):
            values = getattr(r, name)
            assert view[first[i] : first[i] + n[i]].tolist() == (
                [] if values is None else values.tolist())
    for i, r in enumerate(want.references):
        assert (db.text("name", i), db.text("comment", i)) == (r.name, r.comment)
    assert db.objects == 0
    for i in range(len(db)):
        db.reference(i)
    assert db.objects == len(db)


def test_far_pointer_files_have_their_segments(tmp_path, golden_dir):
    """The cases reach what they are named for: the goldens have 2 and 4
    segments, and every moved list sits behind a single-far or a double-far
    pointer (bit 2 of a far pointer)."""
    def segments(path):
        return len(jax_msh._Reader(path.read_bytes()).segments)

    assert segments(golden_dir / "mash_ref/genome1.fna.msh") == 2
    assert segments(golden_dir / "cfl/DNA1-sketch.msh") == 4
    for case, nseg, double in (("far_single", 2, 0), ("far_double", 3, 1)):
        path = _case(case, tmp_path, golden_dir)
        r = jax_msh._Reader(path.read_bytes())
        assert len(r.segments) == nseg
        estart, n, edw, epw = _reference_list(r)
        words = [r.word(0, estart + i * (edw + epw) + edw + slot)
                 for i in range(n) for slot in (2, 3, 5, 6)]
        assert sum(w & 3 == 2 and (w >> 2) & 1 == double for w in words) == 4 * (n - 1) + 2
