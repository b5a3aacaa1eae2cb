"""Port: the merge-join walk's wrapper (plain version on the CPU) vs the JAX package.

The same hash lists, made with numpy from a seed, go through the Pallas walk
kernel in interpret mode, the JAX lockstep XLA walk, the literal walk
``compare_sketches`` and ``fpmash_tpu_torch``'s walk, on adversarially
unsorted lists with duplicates, on sorted lists and on empty ones (as
tests/test_walk.py does).  ``common`` and ``denom`` are integers: exact.
The tests marked ``gpu`` hold the kernel against its plain version on the
card (the cases of ``tests/test_torch_walk_body.py``, both routes, views at
both halves of a 16-byte chunk, wide grids) and skip without one.  JAX is
imported inside the CPU tests only, so that this file also runs where JAX
is absent.
"""

import numpy as np
import pytest
import torch
from test_torch_walk_body import CASES, _case

from fpmash_tpu_torch.models.distance import all_pairs_walk
from fpmash_tpu_torch.models.distance import compare_sketches as port_compare_sketches
from fpmash_tpu_torch.ops import walk_cuda

CPU = torch.device("cpu")


def _rand_list(rng, n, dup_pool=50):
    # small value pool forces duplicates and equal-element steps
    return rng.integers(0, dup_pool, size=n).astype(np.uint64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("S,cap", [(40, 30), (150, 1000), (64, 64), (20, 1000), (32, 16)])
def test_walk_matches_pallas_interpret_and_xla(S, cap):
    import jax.numpy as jnp

    from fpmash_tpu.ops.walk import pairwise_walk_common_denom
    from fpmash_tpu.ops.walk_pallas import pairwise_walk_pallas

    rng = np.random.default_rng(S + cap)
    R = Q = 8
    ref = rng.integers(0, 60, size=(R, S)).astype(np.uint64)
    qry = rng.integers(0, 60, size=(Q, S)).astype(np.uint64)
    ref[0, :] |= np.uint64(1 << 63)  # high bit set: unsigned order matters
    rl = rng.integers(0, S + 1, size=R).astype(np.int32)
    ql = rng.integers(0, S + 1, size=Q).astype(np.int32)
    jargs = (jnp.asarray(ref), jnp.asarray(rl), jnp.asarray(qry), jnp.asarray(ql))
    c1, d1 = pairwise_walk_pallas(*jargs, sketch_size=cap, interpret=True)
    c0, d0 = pairwise_walk_common_denom(*jargs, sketch_size=cap)
    c, d = walk_cuda.pairwise_walk(
        _t(ref.view(np.int64)), _t(rl), _t(qry.view(np.int64)), _t(ql), cap
    )
    assert np.array_equal(c.numpy(), np.asarray(c1)) and np.array_equal(d.numpy(), np.asarray(d1))
    assert np.array_equal(c.numpy(), np.asarray(c0)) and np.array_equal(d.numpy(), np.asarray(d0))


def _literal(refs, qrys, S):
    from fpmash_tpu.models.distance import compare_sketches

    common = np.zeros((len(refs), len(qrys)), np.int32)
    denom = np.zeros_like(common)
    for ri, A in enumerate(refs):
        for qi, B in enumerate(qrys):
            res = compare_sketches(A, B, 100, 100, S, 21, 4.0**21)
            common[ri, qi], denom[ri, qi] = res.numer, res.denom
    return common, denom


@pytest.mark.parametrize("S", [4, 17, 100])
def test_all_pairs_walk_unsorted_matches_literal_and_jax(S):
    from fpmash_tpu.ops.walk import all_pairs_walk as jax_all_pairs_walk

    rng = np.random.default_rng(S)
    refs = [_rand_list(rng, int(rng.integers(0, 2 * S + 1))) for _ in range(7)]
    qrys = [_rand_list(rng, int(rng.integers(0, 2 * S + 1))) for _ in range(5)]
    c, d = all_pairs_walk(refs, qrys, S, devices=(CPU,))
    lc, ld = _literal(refs, qrys, S)
    jc, jd = jax_all_pairs_walk(refs, qrys, S)
    assert np.array_equal(c, lc) and np.array_equal(d, ld)
    assert np.array_equal(c, jc) and np.array_equal(d, jd)


def test_all_pairs_walk_sorted_inputs():
    """On sorted lists the walk is the sorted comparison (the JAX package's
    compare kernel, and the literal walk)."""
    from fpmash_tpu.ops.compare import all_pairs_common_denom

    rng = np.random.default_rng(3)
    S = 64
    def mk():
        n = int(rng.integers(1, S + 1))
        return np.sort(rng.choice(10**6, n, replace=False).astype(np.uint64))
    refs = [mk() for _ in range(6)]
    qrys = [mk() for _ in range(6)]
    c, d = all_pairs_walk(refs, qrys, S, devices=(CPU,))
    sc, sd = all_pairs_common_denom(refs, qrys, S)
    assert np.array_equal(c, sc) and np.array_equal(d, sd)
    lc, ld = _literal(refs, qrys, S)
    assert np.array_equal(c, lc) and np.array_equal(d, ld)


def test_all_pairs_walk_empty_lists():
    refs = [np.array([], np.uint64), np.array([5, 3], np.uint64)]
    qrys = [np.array([3], np.uint64), np.array([], np.uint64)]
    c, d = all_pairs_walk(refs, qrys, 10, devices=(CPU,))
    lc, ld = _literal(refs, qrys, 10)
    assert np.array_equal(c, lc) and np.array_equal(d, ld)
    c, d = all_pairs_walk([], qrys, 10, devices=(CPU,))
    assert c.shape == d.shape == (0, 2)


def test_compare_sketches_copy_matches_jax():
    from fpmash_tpu.models.distance import compare_sketches

    rng = np.random.default_rng(12)
    for _ in range(20):
        A = _rand_list(rng, int(rng.integers(0, 40)), dup_pool=30)
        B = _rand_list(rng, int(rng.integers(0, 40)), dup_pool=30)
        args = (A, B, 150, 170, 25, 1, 10.0, 0.9, 0.5)
        assert port_compare_sketches(*args).__dict__ == compare_sketches(*args).__dict__


def test_walk_wrapper_dispatch_and_checks():
    ref = torch.zeros((2, 3), dtype=torch.int64)
    lens = torch.full((2,), 3, dtype=torch.int32)
    before = walk_cuda.LAUNCHES
    c, d = walk_cuda.pairwise_walk(ref, lens, ref, lens, 10)
    assert walk_cuda.LAUNCHES == before  # the plain version is not a launch
    assert c.tolist() == [[3, 3], [3, 3]] and d.tolist() == [[3, 3], [3, 3]]
    with pytest.raises(ValueError, match="cpu or cuda"):
        walk_cuda.pairwise_walk(ref.to("meta"), lens.to("meta"), ref.to("meta"), lens.to("meta"), 10)
    with pytest.raises(ValueError, match="int64"):
        walk_cuda.pairwise_walk(ref.to(torch.int32), lens, ref, lens, 10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


def _assert_kernel_equals_plain(ref, ref_len, qry, qry_len, s):
    before = walk_cuda.LAUNCHES
    got = walk_cuda.pairwise_walk(ref, ref_len, qry, qry_len, s)
    assert walk_cuda.LAUNCHES == before + 1
    want = walk_cuda.pairwise_walk_plain(ref, ref_len, qry, qry_len, s)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("common", "denom")):
        assert torch.equal(g, w), f"{what} differs in {int((g != w).sum())} pairs"
    return got


def _lists_on(dev, lists, offset: int = 0):
    """u64 lists as contiguous int64 on ``dev``, starting ``offset`` elements
    into their buffer (a view at the other half of a 16-byte chunk)."""
    flat = torch.from_numpy(np.ascontiguousarray(lists).view(np.int64).reshape(-1))
    buf = torch.zeros(offset + flat.numel(), dtype=torch.int64, device=dev)
    buf[offset:] = flat.to(dev)
    return buf[offset:].view(lists.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_walk_kernel_matches_plain_on_card(cuda_device, case, offset):
    ref, ref_len, qry, qry_len, s = _case(case)
    ref_t, qry_t = _lists_on(cuda_device, ref, offset), _lists_on(cuda_device, qry, 1 - offset)
    assert (ref_t.data_ptr() - qry_t.data_ptr()) % 16 == 8
    lens = [torch.from_numpy(x).to(cuda_device) for x in (ref_len, qry_len)]
    _assert_kernel_equals_plain(ref_t, lens[0], qry_t, lens[1], min(s, 2**31 - 1))


@pytest.mark.gpu
@pytest.mark.parametrize("R,Q,S1,S2,s", [(1, 5000, 64, 48, 1000), (5000, 1, 48, 64, 1000),
                                         (3, 300, 7000, 2000, 9000), (300, 3, 2000, 6145, 20),
                                         (8, 40, 6144, 6144, 2**31 - 1)],
                         ids=["r1_q_wide", "q1_r_wide", "ref_past_stage", "s_small",
                              "stage_edge"])
def test_walk_kernel_grids_and_routes_on_card(cuda_device, R, Q, S1, S2, s):
    """One reference and many queries, the reverse, reference rows wider than
    the shared-memory stage (the device-memory route) and at its edge;
    unsorted lists over a small value pool, so walks advance both sides."""
    rng = np.random.default_rng(R + Q + S1)
    lists = [rng.integers(0, 3 * max(S1, S2), size=(n, w)).astype(np.uint64)
             for n, w in ((R, S1), (Q, S2))]
    lens = [rng.integers(w // 2, w + 1, size=n).astype(np.int32) for n, w in ((R, S1), (Q, S2))]
    got = _assert_kernel_equals_plain(
        _lists_on(cuda_device, lists[0]), torch.from_numpy(lens[0]).to(cuda_device),
        _lists_on(cuda_device, lists[1]), torch.from_numpy(lens[1]).to(cuda_device), s)
    assert int(got[0].sum()) > 0  # the lists share values: the check is not vacuous
