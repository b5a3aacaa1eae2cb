"""Port: the k-mer kernels K10, K11 and K12 (plain versions on the CPU) vs the JAX package.

They are the JAX package's older formulations of the classic hash, unrouted
there and reached through their own entry points: ``canonical_murmur_pallas``
(K11), ``kmer_hashes_fused_pallas[_planes]`` (K12) and
``kmer_hashes_packed_topk_planes`` (K10).  The same inputs, made with numpy
from a seed, go through those entry points in Pallas interpret mode (as
tests/test_kmers_pallas.py runs them) and through
``fpmash_tpu_torch.ops.kmers_cuda``'s wrappers, which run the plain versions
on the CPU.  Hashes, validity, slots and flags are integers: every
comparison is exact, at every position and slot.

K10's groups and K12's wrap follow the TPU layout at the JAX package's
production row block, ``kmers_pallas.ROW_BLOCK = 2048``, which the port pins
as ``kmers_cuda.ROW_BLOCK``.  tests/conftest.py shrinks that row block for
the JAX package's own tests (``FPMASH_ROW_BLOCK``), so these tests set the
module's ``ROW_BLOCK`` back to 2048 for the call and trace a fresh ``jit``
of the entry point under it.

The tests marked ``gpu`` hold each kernel against its plain version on a
card; the test functions import JAX only inside the CPU tests, so on a
machine with a card and no JAX they run with ``python -m pytest
tests/test_torch_kmer_variants.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import kmers_cuda

U32 = np.uint64(0xFFFFFFFF)
PAD64 = np.uint64(2**64 - 1)


def _u64(lo, hi):
    lo = np.asarray(lo).astype(np.uint64) & U32
    hi = np.asarray(hi).astype(np.uint64) & U32
    return (hi << np.uint64(32)) | lo


def _codes(rng, n, bad_rate=0.01):
    """2-bit codes with invalid ones (4, values above 4, the high bit) sprinkled in."""
    codes = rng.integers(0, 4, size=n).astype(np.uint32)
    bad = rng.random(n) < bad_rate
    codes[bad] = rng.choice(np.array([4, 5, 7, 255, 2**31, 2**32 - 1], np.uint32),
                            size=int(bad.sum()))
    return codes


def _torch_codes(codes):
    return torch.from_numpy(codes.view(np.int32))


def _production_layout(monkeypatch, name):
    """``kmers_pallas.<name>`` traced anew at the production row block."""
    import jax

    import fpmash_tpu.ops.kmers_pallas as kp

    monkeypatch.setattr(kp, "ROW_BLOCK", kmers_cuda.ROW_BLOCK)
    assert kp.ROW_BLOCK == 2048 and kp.GROUPS == kmers_cuda.GROUPS
    assert kp.W_TOPK == kmers_cuda.TOPK_WIDTH and kp.HALO >= 31
    return jax.jit(getattr(kp, name).__wrapped__,
                   static_argnames=("k", "noncanonical", "seed", "interpret"))


@pytest.fixture
def jax_optimized():
    """XLA's optimizations on for one test: the K10 interpret run is
    execution-bound, 4 s optimized against 60 s without (integer kernel, so
    the results are the same)."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# ---------------------------------------------------------------------- #
# K11: canonical murmur of packed windows
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("k", [1, 15, 16, 17, 21, 32])
@pytest.mark.parametrize("noncanonical", [False, True])
def test_canonical_murmur_plain_matches_pallas(k, noncanonical):
    """F and R with random bits above 2k: the pick compares all 64 bits,
    the hash reads only bits [0, 2k)."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.kmers_pallas import canonical_murmur_pallas

    rng = np.random.default_rng(500 + k)
    n = 3000
    F = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    R = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    R[:200] = F[:200]  # ties take F
    low = np.uint64((1 << (2 * k)) - 1)
    R[200:400] = (F[200:400] & low) | (R[200:400] & ~low)  # only the high bits differ
    got = kmers_cuda.canonical_murmur(torch.from_numpy(F.view(np.int64)),
                                      torch.from_numpy(R.view(np.int64)), k=k,
                                      noncanonical=noncanonical)
    want = canonical_murmur_pallas(jnp.asarray(F), jnp.asarray(R), k=k,
                                   noncanonical=noncanonical, interpret=True)
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


def test_canonical_murmur_of_packed_windows_is_k7():
    """On the F and R of a sequence's windows it gives K7/K8's hash."""
    from fpmash_tpu_torch.ops.kmers import _CODES, _pack_windows

    rng = np.random.default_rng(7)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=2000)]
    codes = torch.from_numpy(_CODES[seq])
    for k in (9, 21, 32):
        F, R, valid = _pack_windows(torch.nn.functional.pad(codes, (0, k - 1), value=4),
                                    len(seq), k)
        lo, hi, want_valid = kmers_cuda.kmer_hashes_planes(torch.from_numpy(seq), k=k)
        assert torch.equal(kmers_cuda.canonical_murmur(F, R, k=k), kmers_cuda.join_planes(lo, hi))
        assert torch.equal(valid, want_valid)


# ---------------------------------------------------------------------- #
# K12: the fused scan over a code stream, with the TPU layout's wrap
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1000, 16384, 16401])
@pytest.mark.parametrize("k", [1, 16, 17, 21, 32])
def test_fused_plain_matches_pallas(monkeypatch, n, k):
    """At every position; the joined entry point (the same kernel) at k = 21.
    At N = 16 384 = Np the windows of the last k - 1 positions run past the
    end into the stream's head, so they are valid when head and tail are; at
    16 401 they read the pad."""
    import jax.numpy as jnp

    planes = _production_layout(monkeypatch, "kmer_hashes_fused_pallas_planes")
    rng = np.random.default_rng(600 + k)
    codes = _codes(rng, n)
    codes[:40] = rng.integers(0, 4, size=40)
    codes[-40:] = rng.integers(0, 4, size=40)
    t = _torch_codes(codes)
    lo, hi, valid = kmers_cuda.kmer_hashes_fused_planes(t, k=k)
    jlo, jhi, jvalid = planes(jnp.asarray(codes), k=k, interpret=True)
    assert np.array_equal(_u64(lo.numpy(), hi.numpy()), _u64(jlo, jhi))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    if k == 21:
        joined = _production_layout(monkeypatch, "kmer_hashes_fused_pallas")
        h1, v = kmers_cuda.kmer_hashes_fused(t, k=k)
        jh1, jv = joined(jnp.asarray(codes), k=k, interpret=True)
        assert np.array_equal(h1.numpy().view(np.uint64), np.asarray(jh1))
        assert np.array_equal(v.numpy(), np.asarray(jv))
    assert not valid.numpy()[(codes >= 4)[: n - k + 1].nonzero()[0]].any()
    tail = valid.numpy()[n - k + 1 :]
    assert tail.all() if n % kmers_cuda.BLOCK == 0 else not tail.any()


def test_fused_matches_k7_where_windows_fit():
    """At positions <= N - k a code stream hashes as its bytes do under K7/K8."""
    rng = np.random.default_rng(11)
    codes = _codes(rng, 5000, bad_rate=0.02)
    seq = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes, 4)]
    for k in (5, 21):
        lo, hi, valid = kmers_cuda.kmer_hashes_fused_planes(_torch_codes(codes), k=k)
        blo, bhi, bvalid = kmers_cuda.kmer_hashes_planes(torch.from_numpy(seq), k=k)
        fit = 5000 - k + 1
        assert torch.equal(valid[:fit], bvalid[:fit])
        assert torch.equal(kmers_cuda.join_planes(lo, hi)[:fit][valid[:fit]],
                           kmers_cuda.join_planes(blo, bhi)[:fit][bvalid[:fit]])


# ---------------------------------------------------------------------- #
# K10: the top-8 of the TPU kernel's own groups
# ---------------------------------------------------------------------- #


def test_packed_topk_plain_matches_pallas_slot_for_slot(monkeypatch, jax_optimized):
    """The case of tests/test_kmers_pallas.py (N = 65 536, k = 21, the s = 16
    threshold, a duplicated half and invalid codes) cut at N - 777, then the
    monomer, whose groups hold 128 copies of one survivor and overflow."""
    import jax.numpy as jnp

    topk = _production_layout(monkeypatch, "kmer_hashes_packed_topk_planes")
    rng = np.random.default_rng(17)
    N, k, s = 1 << 16, 21, 16
    codes = rng.integers(0, 4, size=N).astype(np.uint32)
    codes[: N // 2] = codes[N // 2 :]
    codes[5000:5010] = 4
    t_hi = int(8.0 * s / (N - (k - 1)) * 2**32)
    length = N - 777
    clo, chi, overflow = kmers_cuda.kmer_hashes_packed_topk_planes(_torch_codes(codes), t_hi,
                                                                   length, k=k)
    jlo, jhi, jover = topk(jnp.asarray(codes), jnp.uint32(t_hi), jnp.int32(length), k=k,
                           interpret=True)
    got = _u64(clo.numpy(), chi.numpy())
    assert clo.shape == (N // 16,) and not bool(overflow) and not bool(jover)
    assert np.array_equal(got, _u64(jlo, jhi))
    survivors = np.sort(got[got != PAD64])
    assert len(survivors) > 100

    # the same survivors as K5 (the port's own groups) as a multiset
    seq = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes, 4)]
    klo, khi, kover = kmers_cuda.kmer_hashes_topk8_planes(torch.from_numpy(seq), t_hi, length,
                                                          k=k)
    k5 = _u64(klo.numpy(), khi.numpy())
    assert not bool(kover) and np.array_equal(survivors, np.sort(k5[k5 != PAD64]))

    mono = np.zeros(N, np.uint32)
    clo, chi, overflow = kmers_cuda.kmer_hashes_packed_topk_planes(_torch_codes(mono),
                                                                   0xFFFFFFFF, N, k=k)
    jlo, jhi, jover = topk(jnp.asarray(mono), jnp.uint32(0xFFFFFFFF), jnp.int32(N), k=k,
                           interpret=True)
    assert bool(overflow) and bool(jover)
    assert np.array_equal(_u64(clo.numpy(), chi.numpy()), _u64(jlo, jhi))


def test_packed_topk_groups_are_the_tpu_layout():
    """Slot 1024 c + 128 i + j holds rank i of positions 16384 c + 2048 s +
    j + 128 m, on a partial second block."""
    rng = np.random.default_rng(19)
    N, k = kmers_cuda.BLOCK + 3000, 21
    codes = _codes(rng, N)
    t_hi, length = 0x40000000, N - 5
    clo, chi, overflow = kmers_cuda.kmer_hashes_packed_topk_planes(_torch_codes(codes), t_hi,
                                                                   length, k=k)
    seq = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes, 4)]
    mlo, mhi = kmers_cuda.kmer_hashes_masked_planes(torch.from_numpy(seq), t_hi, length, k=k)
    masked = np.full(2 * kmers_cuda.BLOCK, PAD64)
    masked[:N] = _u64(mlo.numpy(), mhi.numpy())
    groups = masked.reshape(2, 8, 16, 128).transpose(0, 3, 1, 2).reshape(2, 128, 128)
    want = np.sort(groups, axis=2)[:, :, :8].transpose(0, 2, 1).reshape(-1)
    assert np.array_equal(_u64(clo.numpy(), chi.numpy()), want)
    assert bool(overflow) == bool(((groups != PAD64).sum(axis=2) > 8).any())


def test_variant_wrappers_check_and_count():
    codes = torch.zeros(100, dtype=torch.int32)
    before = dict(kmers_cuda.LAUNCHES)
    kmers_cuda.kmer_hashes_fused_planes(codes, k=21)
    kmers_cuda.kmer_hashes_packed_topk_planes(codes, 0, 100, k=21)
    kmers_cuda.canonical_murmur(codes.long(), codes.long(), k=21)
    assert kmers_cuda.LAUNCHES == before  # the plain versions are not launches
    with pytest.raises(ValueError, match="int32"):
        kmers_cuda.kmer_hashes_fused(codes.to(torch.uint8), k=21)
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        kmers_cuda.kmer_hashes_fused(codes, k=33)
    with pytest.raises(ValueError, match="16 < k <= 32"):
        kmers_cuda.kmer_hashes_packed_topk_planes(codes, 0, 100, k=16)
    with pytest.raises(ValueError, match="length"):
        kmers_cuda.kmer_hashes_packed_topk_planes(codes, 0, 101, k=21)
    with pytest.raises(ValueError, match="F and R differ"):
        kmers_cuda.canonical_murmur(codes.long(), codes[:50].long(), k=21)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kmers_cuda.canonical_murmur(codes.long().to("meta"), codes.long().to("meta"), k=21)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 21, 32])
def test_variant_kernels_match_plain_on_card(cuda_device, k):
    """K12 also with windows across ``Np``: at ``N = Np`` (one and two
    blocks, valid head and tail) the last ``k - 1`` windows read the
    stream's head; codes 5-7 on the tile edges; and on a view that is not
    16-byte aligned (the staging's element-wise loads)."""
    rng = np.random.default_rng(700 + k)
    for n in (kmers_cuda.BLOCK, 2 * kmers_cuda.BLOCK, 3 * kmers_cuda.BLOCK + 77):
        host = _codes(rng, n)
        host[:40] = rng.integers(0, 4, size=40)
        host[-40:] = rng.integers(0, 4, size=40)
        host[4095:4097] = (5, 7)
        codes = _torch_codes(host).to(cuda_device)
        for view in (codes, codes[1:]):
            before = kmers_cuda.LAUNCHES["codes_planes"]
            got = kmers_cuda.kmer_hashes_fused_planes(view, k=k)
            assert kmers_cuda.LAUNCHES["codes_planes"] == before + 1
            want = kmers_cuda.kmer_hashes_fused_planes_plain(view, k=k)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            if view is codes and n % kmers_cuda.BLOCK == 0 and k > 1:
                assert bool(got[2][n - k + 1 :].all())  # the wrapped windows are valid

        F = torch.from_numpy(rng.integers(0, 2**64, size=n, dtype=np.uint64).view(np.int64))
        R = F ^ torch.from_numpy(rng.integers(0, 4, size=n).astype(np.int64) << 40)
        F, R = F.to(cuda_device), R.to(cuda_device)
        for noncanonical in (False, True):
            got = kmers_cuda.canonical_murmur(F, R, k=k, noncanonical=noncanonical)
            assert torch.equal(got, kmers_cuda.canonical_murmur_plain(
                F, R, k=k, noncanonical=noncanonical))
        if k <= 16:
            continue
        for t_hi, length, view in ((0x00800000, n, codes), (0x30000000, n - 500, codes),
                                   (0xFFFFFFFF, n - 1, codes), (0x30000000, n - 1, codes[1:])):
            before = kmers_cuda.LAUNCHES["topk_groups"]
            got = kmers_cuda.kmer_hashes_packed_topk_planes(view, t_hi, length, k=k)
            assert kmers_cuda.LAUNCHES["topk_groups"] == before + 1
            want = kmers_cuda.kmer_hashes_packed_topk_planes_plain(view, t_hi, length, k=k)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
