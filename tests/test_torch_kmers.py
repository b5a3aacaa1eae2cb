"""Port: the k-mer hash kernels' plain versions and the k-mer routes vs the JAX package.

The same bytes, made with numpy from a seed, go through the JAX package's
Pallas kernels in interpret mode (K7/K8 ``kmer_hashes_route_planes``, K6
``kmer_hashes_packed_masked_planes``, K5 ``kmer_hashes_packed_topk8r_planes``),
its XLA formulations (``_kmer_hashes_acgt``, ``_kmer_hashes_generic``), the
scalar MurmurHash3 and ``fpmash_tpu_torch``'s wrappers, which run the plain
versions on the CPU.  Hashes are integers: every comparison is exact.

The tests marked ``gpu`` hold each kernel against its plain version on a
card, and the direct classic route and the CLI on the card against the
CPU; the test functions import JAX only inside the CPU tests, so on a
machine with a card and no JAX they run with ``python -m pytest
tests/test_torch_kmers.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import kmers, kmers_cuda
from fpmash_tpu_torch.ops.murmur3 import murmur3_bytes_batch

U32 = np.uint64(0xFFFFFFFF)


def _mixed_bytes(rng, n, invalid_rate=0.01):
    """ACGT with lowercase stretches, and N, IUPAC codes and NUL sprinkled in."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()
    for start in rng.integers(0, n, size=max(1, n // 400)):
        seq[start : start + int(rng.integers(5, 60))] += 32  # lowercase stretch
    bad = rng.random(n) < invalid_rate
    seq[bad] = np.frombuffer(b"NRYKM\x00n", np.uint8)[rng.integers(0, 7, size=int(bad.sum()))]
    return seq


def _jax_codes(seq, preserve_case):
    """The JAX package's code preparation (``ops/kmers.py:366-372``)."""
    import jax.numpy as jnp

    s = seq.copy()
    if not preserve_case:
        lower = (s > 96) & (s < 123)
        s[lower] -= 32
    codes = np.full(len(s), 4, np.uint32)
    for v, ch in enumerate(b"ACGT"):
        codes[s == ch] = v
    return jnp.asarray(codes)


def _u64(lo, hi):
    lo = np.asarray(lo).astype(np.uint64) & U32
    hi = np.asarray(hi).astype(np.uint64) & U32
    return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize(
    "k,noncanonical,preserve_case",
    [(9, False, False), (16, False, True), (16, True, False), (17, False, False),
     (21, True, True), (21, False, False), (31, False, False), (32, False, False),
     (32, True, False)],
)
def test_planes_plain_matches_pallas_route_and_xla(k, noncanonical, preserve_case):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import _kmer_hashes_acgt as jax_kmer_hashes_acgt
    from fpmash_tpu.ops.kmers_pallas import kmer_hashes_route_planes
    from fpmash_tpu.scalar.murmur3 import hash_bytes

    rng = np.random.default_rng(100 + k)
    seq = _mixed_bytes(rng, 3000)
    kw = dict(k=k, noncanonical=noncanonical, seed=42)
    lo, hi, valid = kmers_cuda.kmer_hashes_planes(torch.from_numpy(seq),
                                                  preserve_case=preserve_case, **kw)
    jlo, jhi, jvalid = kmer_hashes_route_planes(_jax_codes(seq, preserve_case), interpret=True,
                                                **kw)
    mine = _u64(lo.numpy(), hi.numpy())
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(mine, _u64(jlo, jhi))  # every lane, valid or not
    assert valid.sum() > 100

    # the XLA formulation agrees on the valid windows (it packs invalid bytes
    # differently), with the length cut applied
    length = 2900
    h0, v0 = jax_kmer_hashes_acgt(jnp.asarray(seq), jnp.int32(length), pallas=False,
                                  preserve_case=preserve_case, **kw)
    h, v = kmers.kmer_hashes(torch.from_numpy(seq), length, preserve_case=preserve_case, **kw)
    assert np.array_equal(v.numpy(), np.asarray(v0))
    assert np.array_equal(h.numpy().view(np.uint64)[v.numpy()], np.asarray(h0)[np.asarray(v0)])

    # and a sample against the scalar MurmurHash3 of the canonical k bytes
    ctab = kmers.complement_table()
    text = seq if preserve_case else np.where((seq > 96) & (seq < 123), seq - 32, seq)
    for p in rng.choice(np.flatnonzero(v.numpy()), 16, replace=False):
        kmer = bytes(text[p : p + k])
        rc = bytes(ctab[np.frombuffer(kmer, np.uint8)][::-1])
        want = hash_bytes(kmer if noncanonical else min(kmer, rc), seed=42)
        assert int(mine[p]) == want


@pytest.mark.parametrize("k", [17, 21, 32])
def test_masked_plain_matches_pallas(k):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers_pallas import kmer_hashes_packed_masked_planes

    rng = np.random.default_rng(200 + k)
    seq = _mixed_bytes(rng, 4096)
    codes = _jax_codes(seq, False)
    for t_hi, length in ((0x10000000, 4096), (0xC0000000, 3000), (0xFFFFFFFF, 4000)):
        lo, hi = kmers_cuda.kmer_hashes_masked_planes(torch.from_numpy(seq), t_hi, length, k=k)
        jlo, jhi = kmer_hashes_packed_masked_planes(codes, jnp.uint32(t_hi), jnp.int32(length),
                                                    k=k, interpret=True)
        mine = _u64(lo.numpy(), hi.numpy())
        assert np.array_equal(mine, _u64(jlo, jhi))
        kept = mine != np.uint64(2**64 - 1)
        assert kept.any() and not kept[length - k + 1 :].any()


def _survivors(lo, hi):
    v = _u64(lo, hi)
    return np.sort(v[v != np.uint64(2**64 - 1)])


@pytest.mark.parametrize("k,noncanonical", [(21, False), (32, True)])
def test_topk8_plain_matches_pallas_as_multisets(k, noncanonical):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers_pallas import kmer_hashes_packed_topk8r_planes

    rng = np.random.default_rng(300 + k)
    N = 1 << 14
    seq = _mixed_bytes(rng, N)
    codes = _jax_codes(seq, False)
    t_hi, length = 0x01000000, N - 1000  # about 64 survivors
    clo, chi, overflow = kmers_cuda.kmer_hashes_topk8_planes(
        torch.from_numpy(seq), t_hi, length, k=k, noncanonical=noncanonical)
    jlo, jhi, jover = kmer_hashes_packed_topk8r_planes(
        codes, jnp.uint32(t_hi), jnp.int32(length), k=k, noncanonical=noncanonical,
        interpret=True)
    assert clo.shape == (N // 16,) and not bool(overflow) and not bool(jover)
    got = _survivors(clo.numpy(), chi.numpy())
    assert len(got) > 20
    assert np.array_equal(got, _survivors(jlo, jhi))
    # every survivor of the masked planes, duplicates kept
    mlo, mhi = kmers_cuda.kmer_hashes_masked_planes(torch.from_numpy(seq), t_hi, length, k=k,
                                                    noncanonical=noncanonical)
    assert np.array_equal(got, _survivors(mlo.numpy(), mhi.numpy()))
    # groups of 128 positions, 8 ascending slots each
    groups = _u64(clo.numpy(), chi.numpy()).reshape(-1, 8)
    assert (np.diff(groups.astype(np.float64), axis=1) >= 0).all()


def test_topk8_overflow_on_repeats():
    """A repeat-heavy stream puts more than 8 survivors in a group of 128:
    both kernels flag it, and the port's 8 kept per group are the smallest."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers_pallas import kmer_hashes_packed_topk8r_planes

    rng = np.random.default_rng(5)
    unit = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=40)]
    seq = np.tile(unit, 4096 // 40 + 1)[:4096].copy()
    t_hi = 0x40000000  # a quarter of the hash space: many of 40 distinct k-mers
    clo, chi, overflow = kmers_cuda.kmer_hashes_topk8_planes(torch.from_numpy(seq), t_hi, 4096,
                                                             k=21)
    _, _, jover = kmer_hashes_packed_topk8r_planes(_jax_codes(seq, False), jnp.uint32(t_hi),
                                                   jnp.int32(4096), k=21, interpret=True)
    assert bool(overflow) and bool(jover)
    mlo, mhi = kmers_cuda.kmer_hashes_masked_planes(torch.from_numpy(seq), t_hi, 4096, k=21)
    masked = _u64(mlo.numpy(), mhi.numpy()).reshape(-1, 128)
    want = np.sort(masked, axis=1)[:, :8]
    assert np.array_equal(_u64(clo.numpy(), chi.numpy()).reshape(-1, 8), want)


@pytest.mark.parametrize("alphabet,k,noncanonical", [
    ("ACDEFGHIKLMNPQRSTVWY", 9, True), ("ACGT", 35, False), ("ACGU", 12, True)])
def test_generic_route_matches_jax(alphabet, k, noncanonical):
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers import _kmer_hashes_generic as jax_kmer_hashes_generic

    rng = np.random.default_rng(k)
    upper = np.frombuffer(alphabet.encode(), np.uint8)
    other = np.frombuffer((alphabet.lower() + "XB*").encode(), np.uint8)
    seq = upper[rng.integers(0, len(upper), size=1500)]
    odd = rng.random(1500) < 0.03
    seq[odd] = other[rng.integers(0, len(other), size=int(odd.sum()))]
    kw = dict(alphabet=alphabet, k=k, noncanonical=noncanonical, seed=7)
    h, v = kmers.kmer_hashes(torch.from_numpy(seq), 1450, **kw)
    jh, jv = jax_kmer_hashes_generic(jnp.asarray(seq), jnp.int32(1450), use64=True, **kw)
    v, jv = v.numpy(), np.asarray(jv)
    assert np.array_equal(v, jv) and v.sum() > 10
    assert np.array_equal(h.numpy().view(np.uint64)[v], np.asarray(jh)[jv])


def test_murmur3_bytes_batch_matches_scalar():
    from fpmash_tpu.scalar.murmur3 import murmur3_x64_128

    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=(64, 40), dtype=np.uint8)
    lengths = rng.integers(0, 41, size=64)
    h1, h2 = murmur3_bytes_batch(torch.from_numpy(data), torch.from_numpy(lengths), seed=99)
    for b in range(64):
        want = murmur3_x64_128(bytes(data[b, : lengths[b]]), 99)
        assert (int(h1[b]) & (2**64 - 1), int(h2[b]) & (2**64 - 1)) == want


def test_wrappers_check_and_count():
    seq = torch.from_numpy(kmers.encode_seq("ACGT" * 64))
    before = dict(kmers_cuda.LAUNCHES)
    kmers_cuda.kmer_hashes_planes(seq, k=21)
    assert kmers_cuda.LAUNCHES == before  # the plain versions are not launches
    with pytest.raises(ValueError, match="16 < k <= 32"):
        kmers_cuda.kmer_hashes_masked_planes(seq, 0, 256, k=16)
    with pytest.raises(ValueError, match="length"):
        kmers_cuda.kmer_hashes_topk8_planes(seq, 0, 257, k=21)
    with pytest.raises(ValueError, match="uint8"):
        kmers_cuda.kmer_hashes_planes(seq.to(torch.int32), k=21)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kmers_cuda.kmer_hashes_planes(seq.to("meta"), k=21)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


#: positions a block of the k-mer kernels stages and hashes (csrc/kmer_hash.cu kTile)
TILE = 4096


def _tile_edge_bytes(rng, n):
    """Mixed bytes with N on each side of every tile edge, 31 past it (the
    halo's last position) and at the stream's end."""
    seq = _mixed_bytes(rng, n)
    for edge in range(TILE, n + 1, TILE):
        for d in (-1, 0, 31):
            if 0 <= edge + d < n:
                seq[edge + d] = ord("N")
    seq[-1] = ord("n")
    return seq


@pytest.mark.gpu
@pytest.mark.parametrize("k,noncanonical,preserve_case", [
    (1, False, False), (9, False, False), (16, True, True), (17, False, False),
    (21, False, True), (32, False, False)])
def test_kmer_kernels_match_plain_on_card(cuda_device, k, noncanonical, preserve_case):
    """At a length with a partial group of 128 at the end, at tile multiples
    and one off them (invalid bytes on the tile edges), and on a view that
    is not 16-byte aligned (the staging's byte-wise loads)."""
    rng = np.random.default_rng(400 + k)
    kw = dict(k=k, noncanonical=noncanonical, preserve_case=preserve_case, seed=42)
    name = "planes_k16" if k <= 16 else "planes_k32"
    for N in ((1 << 16) + 77, 4 * TILE - 1, 4 * TILE, 4 * TILE + 1, TILE + 3):
        seq = torch.from_numpy(_tile_edge_bytes(rng, N + 3)).to(cuda_device)
        seq = seq[3:] if N == TILE + 3 else seq[:N]
        before = kmers_cuda.LAUNCHES[name]
        got = kmers_cuda.kmer_hashes_planes(seq, **kw)
        assert kmers_cuda.LAUNCHES[name] == before + 1
        want = kmers_cuda.kmer_hashes_planes_plain(seq, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if k <= 16:
            continue
        for t_hi, length in ((0x00800000, N), (0x30000000, N - 500), (0xFFFFFFFF, N - 1)):
            got = kmers_cuda.kmer_hashes_masked_planes(seq, t_hi, length, **kw)
            want = kmers_cuda.kmer_hashes_masked_planes_plain(seq, t_hi, length, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            got = kmers_cuda.kmer_hashes_topk8_planes(seq, t_hi, length, **kw)
            want = kmers_cuda.kmer_hashes_topk8_planes_plain(seq, t_hi, length, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert bool(got[2]) == bool(want[2])
            if N == (1 << 16) + 77:
                assert bool(got[2]) == (t_hi > 0x00800000)  # dense thresholds overflow


@pytest.mark.gpu
def test_cli_on_card_matches_cpu(cuda_device, tmp_path, capsys):
    """``sketch -a -i`` (the generic route: plain torch on the card),
    ``sketch -r -m 2``, ``sketch -k 15`` and ``dist`` of sequence files
    give the same bytes on the card as on the CPU."""
    from fpmash_tpu_torch.cli import main

    rng = np.random.default_rng(12)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=6000)].tobytes().decode()
    (tmp_path / "g.fa").write_text(f">g one\n{genome}\n")
    starts = rng.integers(0, len(genome) - 100, size=400)
    (tmp_path / "r.fq").write_text("".join(f"@r{i}\n{genome[p : p + 100]}\n+\n{'I' * 100}\n"
                                           for i, p in enumerate(starts)))
    amino = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    protein = amino[rng.integers(0, 20, size=3000)].tobytes().decode()
    (tmp_path / "p.fa").write_text(f">p\n{protein}\n>q\n{protein[::-1]}\n")
    runs = {"protein": ["-a", "-i", "p.fa"], "reads": ["-r", "-m", "2", "r.fq"],
            "k15": ["-k", "15", "g.fa"]}
    printed = {}
    for dev in ("cpu", "cuda"):
        for name, args in runs.items():
            args = [str(tmp_path / a) if a.endswith((".fa", ".fq")) else a for a in args]
            assert main(["sketch", *args, "-o", str(tmp_path / f"{name}_{dev}"),
                         "--device", dev]) == 0
        capsys.readouterr()
        assert main(["dist", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"), "--device", dev]) == 0
        printed[dev] = capsys.readouterr().out
    for name in runs:
        assert (tmp_path / f"{name}_cuda.msh").read_bytes() == (tmp_path / f"{name}_cpu.msh").read_bytes()
    assert printed["cuda"] == printed["cpu"] and printed["cpu"]


@pytest.mark.gpu
def test_direct_route_on_card_matches_cpu(cuda_device, monkeypatch):
    from fpmash_tpu_torch.models import sketch as port_sketch

    monkeypatch.setattr(port_sketch, "_DIRECT_CHUNK", 1 << 15)
    rng = np.random.default_rng(8)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=100_000)].tobytes().decode()
    seq = seq[:40_000] + seq[:40_000] + seq[40_000:]
    for params in (dict(sketch_size=16, counts=True), dict(sketch_size=64),
                   dict(sketch_size=16, min_cov=2, reads=True, counts=True)):
        p = port_sketch.SketchParams(**params)
        before = sum(kmers_cuda.LAUNCHES.values())
        card = port_sketch._sketch_pools([seq], p, (cuda_device,))
        assert sum(kmers_cuda.LAUNCHES.values()) > before
        cpu = port_sketch._sketch_pools([seq], p, (torch.device("cpu"),))
        assert np.array_equal(card[0], cpu[0]) and np.array_equal(card[1], cpu[1])
