"""Port: the `.msh` writer lays out the JAX package's bytes.

Each case writes one ``MshFile`` with the port's ``write_msh`` and with
``fpmash_tpu.utils.msh.write_msh``, asserts equal bytes, and reads the
port's file back with the port's ``read_msh``.
"""

import numpy as np
import pytest

from fpmash_tpu.utils import msh as jax_msh
from fpmash_tpu_torch.utils import msh

RNG = np.random.default_rng(20)


def _u32(n):
    return np.sort(RNG.integers(0, 2**32, n, dtype=np.uint64)).astype(np.uint32)


def _u64(n):
    return np.sort(RNG.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True))


def _refs(**kw):
    return [dict(name=f"r{i}", comment="c", length=1000 + i) | kw for i in range(3)]


CASES = {
    "seed42_u32_even": dict(kmer_size=1, alphabet="0123456789", references=[
        dict(name="a", comment="", length=2000, hashes32=_u32(2000)),
        dict(name="b", comment="x", length=5, hashes32=_u32(4))]),
    "seed7_u32_odd": dict(kmer_size=1, alphabet="0123456789", hash_seed=7, references=[
        dict(name="a", comment="", length=11, hashes32=_u32(11)),
        dict(name="b", comment="", length=1, hashes32=_u32(1))]),
    "seed0_u64": dict(hash_seed=0, references=_refs(hashes64=_u64(1000))),
    "u64_counts_sorted": dict(references=[
        dict(name="reads", comment="", length=502359, hashes64=_u64(999),
             counts32=RNG.integers(1, 50, 999, dtype=np.uint32), counts32_sorted=True)]),
    "u32_counts_unsorted": dict(kmer_size=15, references=[
        dict(name="reads", comment="", length=77, hashes32=_u32(7),
             counts32=np.arange(1, 8, dtype=np.uint32))]),
    "empty_hash_lists": dict(references=[
        dict(name="no32", comment="", length=0, hashes32=np.zeros(0, np.uint32)),
        dict(name="no64", comment="", length=0, hashes64=np.zeros(0, np.uint64),
             counts32=np.zeros(0, np.uint32)),
        dict(name="none", comment=None, length=3)]),
    "text_widths": dict(references=[
        dict(name="", comment="", length=1, hashes64=_u64(2)),
        dict(name="abcdefg", comment="abcdefgh", length=2, hashes64=_u64(3)),
        dict(name="abcdefghabcdefgh", comment="séquence Ω → 日本語 🧬", length=3,
             hashes64=_u64(1)),
        dict(name="名前", comment="c with spaces\r", length=4)]),
    "header_fields": dict(kmer_size=9, window_size=0, min_hashes_per_window=123,
                          concatenated=False, error=0.01, noncanonical=True,
                          alphabet="ACDEFGHIKLMNPQRSTVWY", preserve_case=True,
                          hash_seed=2**32 - 1, references=_refs(hashes64=_u64(5))),
    "no_references": dict(references=[]),
    "windowed_loci": dict(kmer_size=15, window_size=1000, min_hashes_per_window=10,
                          concatenated=False, references=[
                              dict(name="chr", comment="", length=5000, hashes64=_u64(4)),
                              dict(name="plasmid", comment="p", length=300,
                                   hashes64=_u64(3))],
                          loci=[(0, 0, 2**64 - 1), (0, 4999, 17), (1, 2**32 - 1, 0),
                                (1, 12, 2**63)]),
}


def _file(mod, case):
    fields = dict(case)
    refs = [mod.MshReference(**r) for r in fields.pop("references")]
    return mod.MshFile(references=refs, **fields)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_writes_the_jax_packages_bytes(name, tmp_path):
    case = CASES[name]
    port, ref = tmp_path / "port.msh", tmp_path / "jax.msh"
    msh.write_msh(str(port), _file(msh, case))
    jax_msh.write_msh(str(ref), _file(jax_msh, case))
    assert port.read_bytes() == ref.read_bytes()

    back = msh.read_msh(str(port))
    want = _file(msh, case)
    for attr in ("kmer_size", "window_size", "min_hashes_per_window", "concatenated",
                 "noncanonical", "alphabet", "preserve_case", "hash_seed", "loci"):
        assert getattr(back, attr) == getattr(want, attr), attr
    assert back.error == pytest.approx(want.error, rel=1e-7)
    assert len(back.references) == len(want.references)
    for got, r in zip(back.references, want.references):
        assert (got.name, got.comment, got.length) == (r.name, r.comment or "", r.length)
        for attr in ("hashes32", "hashes64"):
            assert list(getattr(got, attr)) == list(getattr(r, attr) if getattr(r, attr)
                                                    is not None else [])
        counts = r.counts32 if r.counts32 is not None and len(r.counts32) else None
        assert (got.counts32 is None) == (counts is None)
        if counts is not None:
            assert list(got.counts32) == list(counts)
            assert got.counts32_sorted == r.counts32_sorted
