"""Port: the sorted all-pairs comparison K9 (plain version on the CPU) vs the JAX package.

The same sorted hash lists, made with numpy from a seed, go through the JAX
package's XLA formulation (``fpmash_tpu.ops.compare.pairwise_common_denom``),
its Pallas kernel in interpret mode (as ``tests/test_compare_pallas.py`` runs
it) and the port's plain version of K9: distinct lists with pads, lists with
repeated hashes, a real ``2^64 - 1`` hash, empty lists, caps below and above
the list widths.  ``dist`` on sorted lists with repeats is pinned against the
JAX package's device route, and the positional comparison of ``triangle
-fp`` against ``pairwise_positional``.  Counts are integers: exact.

JAX is imported inside the CPU tests only, so that the ``gpu`` tests (K9
against its plain version on the card) run where JAX is not installed:
``python -m pytest tests/test_torch_compare.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models import distance as port_distance
from fpmash_tpu_torch.models.sketch import sketch_from_arrays
from fpmash_tpu_torch.ops import compare as port_compare
from fpmash_tpu_torch.ops import compare_cuda

CPU = torch.device("cpu")
U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _args(ref, rl, qry, ql, device=CPU):
    return tuple(_t(a).to(device) for a in (ref.view(np.int64), rl, qry.view(np.int64), ql))


def _distinct_rows(rng, n, S, lo_len, hi_len):
    """Sorted distinct rows padded with 2^64 - 1 (tests/test_compare_pallas.py)."""
    rows = np.full((n, S), U64MAX)
    lens = rng.integers(lo_len, hi_len + 1, n).astype(np.int32)
    for i in range(n):
        rows[i, : lens[i]] = np.sort(
            rng.choice(np.arange(1, 10**6, dtype=np.uint64), int(lens[i]), replace=False))
    return rows, lens


def _repeat_rows(rng, n, S):
    """Sorted rows drawn from a small pool (repeated hashes), some with the
    high bit set, some ending in a real 2^64 - 1, some of length 0 or 1."""
    rows = np.sort(rng.integers(0, 3 * S // 2, size=(n, S)).astype(np.uint64), axis=1)
    rows[::3] = np.sort(rows[::3] | np.uint64(1 << 63), axis=1)
    rows[1::5, -2:] = U64MAX
    lens = rng.integers(0, S + 1, n).astype(np.int32)
    lens[:2] = [0, 1]
    lens[4] = S
    return rows, lens


def _jax_both(ref, rl, qry, ql, cap):
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import pairwise_common_denom
    from fpmash_tpu.ops.compare_pallas import pairwise_common_denom_pallas

    jargs = (jnp.asarray(ref), jnp.asarray(rl), jnp.asarray(qry), jnp.asarray(ql))
    xla = pairwise_common_denom(*jargs, sketch_size=cap)
    pallas = pairwise_common_denom_pallas(*jargs, sketch_size=cap, interpret=True)
    return [tuple(np.asarray(x) for x in out) for out in (xla, pallas)]


@pytest.mark.parametrize("S,cap", [(100, 64), (100, 1000), (128, 128), (128, 1000),
                                   (300, 256), (300, 1000)])
def test_plain_k9_matches_jax_xla_and_pallas(S, cap):
    rng = np.random.default_rng(S + cap)
    ref, rl = _distinct_rows(rng, 16, S, S // 2, S)
    qry, ql = _distinct_rows(rng, 16, S, S // 2, S)
    qry[3, :40] = ref[5, :40]  # heavy sharing on some pairs
    qry[3] = np.sort(qry[3])
    qry[7], ql[7] = ref[2], rl[2]  # an identical pair
    c, d = port_compare.pairwise_common_denom(*_args(ref, rl, qry, ql), cap)
    for jc, jd in _jax_both(ref, rl, qry, ql, cap):
        assert np.array_equal(c.numpy(), jc) and np.array_equal(d.numpy(), jd)
    assert int(c[2, 7]) == min(int(rl[2]), cap) and int(c.sum()) > int(c[2, 7])


@pytest.mark.parametrize("S,cap", [(40, 7), (64, 1000), (100, 1)])
def test_plain_k9_on_repeats_matches_jax(S, cap):
    """Sorted rows with repeated hashes: the union-merge multiset counts,
    which differ from the walk's."""
    rng = np.random.default_rng(S * cap)
    ref, rl = _repeat_rows(rng, 16, S)
    qry, ql = _repeat_rows(rng, 16, S)
    c, d = port_compare.pairwise_common_denom(*_args(ref, rl, qry, ql), cap)
    for jc, jd in _jax_both(ref, rl, qry, ql, cap):
        assert np.array_equal(c.numpy(), jc) and np.array_equal(d.numpy(), jd)


def test_plain_k9_equals_literal_walk_on_sorted_distinct_lists():
    from fpmash_tpu.models.distance import compare_sketches

    rng = np.random.default_rng(9)
    refs = [np.sort(rng.choice(10**5, int(n), replace=False)).astype(np.uint64)
            for n in rng.integers(0, 90, 9)]
    qrys = [np.sort(rng.choice(10**5, int(n), replace=False)).astype(np.uint64)
            for n in rng.integers(0, 90, 7)]
    qrys[0] = refs[1][::2].copy()
    for cap in (5, 50, 1000):
        c, d = port_compare.all_pairs_common_denom(refs, qrys, cap, device=CPU)
        for ri, A in enumerate(refs):
            for qi, B in enumerate(qrys):
                res = compare_sketches(A, B, 1, 1, cap, 21, 4.0**21)
                assert (c[ri, qi], d[ri, qi]) == (res.numer, res.denom)


def test_the_issue_example_differs_from_the_walk():
    """A = [5, 5, 9], B = [5, 7]: the union merge gives 2/3, the walk 1/4."""
    A, B = np.array([5, 5, 9], np.uint64), np.array([5, 7], np.uint64)
    c, d = port_compare.all_pairs_common_denom([A], [B], 1000, device=CPU)
    assert (int(c[0, 0]), int(d[0, 0])) == (2, 3)
    res = port_distance.compare_sketches(A, B, 1, 1, 1000, 21, 4.0**21)
    assert (res.numer, res.denom) == (1, 4)


def test_all_pairs_common_denom_tiles_rows(monkeypatch):
    """Row blocks of a few pairs give the untiled result and the JAX host wrapper's."""
    from fpmash_tpu.ops.compare import all_pairs_common_denom as jax_all_pairs

    rng = np.random.default_rng(4)
    refs = [np.sort(rng.integers(0, 300, int(n)).astype(np.uint64)) for n in rng.integers(0, 60, 11)]
    qrys = [np.sort(rng.integers(0, 300, int(n)).astype(np.uint64)) for n in rng.integers(0, 60, 5)]
    whole = port_compare.all_pairs_common_denom(refs, qrys, 40, device=CPU)
    monkeypatch.setattr(port_compare, "_TILE_PAIRS", 7)
    monkeypatch.setattr(port_compare, "_PLAIN_ELEMENTS", 300)
    tiled = port_compare.all_pairs_common_denom(refs, qrys, 40, device=CPU)
    want = jax_all_pairs(refs, qrys, 40)
    for got in (whole, tiled):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _sketches(rng, n, S, sorted_=True):
    def refs():
        out = []
        for i in range(n):
            h = rng.integers(0, S, int(rng.integers(0, S + 1))).astype(np.uint64)
            out.append(dict(name=f"r{i}", comment="", length=int(rng.integers(500, 5000)),
                            hashes=np.sort(h) if sorted_ else h))
        return out

    params = dict(kmer_size=21, sketch_size=S)
    return params, refs()


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted-repeats", "unsorted"])
def test_dist_matches_jax_device_route(monkeypatch, sorted_):
    """8 x 8 lists with repeated hashes: the port's ``all_pairs_dist`` equals
    ``fpmash_tpu.models.distance.all_pairs_dist(backend="jax")`` (K9's
    semantics on sorted lists, the walk's otherwise), and takes the
    matching kernel's route."""
    import fpmash_tpu.models.distance as jax_distance
    import fpmash_tpu.models.sketch as jax_sketch

    rng = np.random.default_rng(8)
    p_ref, r_ref = _sketches(rng, 8, 40, sorted_)
    p_qry, r_qry = _sketches(rng, 8, 30, sorted_)

    def jax_sk(params, refs):
        sk = jax_sketch.Sketch(jax_sketch.SketchParams(**params))
        sk.references = [jax_sketch.Reference(**r) for r in refs]
        return sk

    calls = []
    orig = compare_cuda.pairwise_common_denom
    monkeypatch.setattr(compare_cuda, "pairwise_common_denom",
                        lambda *a: calls.append(1) or orig(*a))
    port = list(port_distance.all_pairs_dist(
        sketch_from_arrays(p_ref, r_ref), sketch_from_arrays(p_qry, r_qry), device=CPU))
    assert bool(calls) == sorted_
    jax = list(jax_distance.all_pairs_dist(jax_sk(p_ref, r_ref), jax_sk(p_qry, r_qry),
                                           backend="jax"))
    assert [(ri, qi, r.__dict__) for ri, qi, r in port] == \
           [(ri, qi, r.__dict__) for ri, qi, r in jax]
    if sorted_:  # the lists repeat hashes: the walk would give other counts
        walk = [port_distance.compare_sketches(r["hashes"], q["hashes"], 1, 1, 30, 21, 4.0**21)
                for q in r_qry for r in r_ref]
        assert any((w.numer, w.denom) != (r.numer, r.denom) for w, (_, _, r) in zip(walk, port))


def test_positional_matches_jax():
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import pairwise_positional, positional_matches

    rng = np.random.default_rng(31)
    lists = [rng.integers(0, 4, int(n)).astype(np.uint64) for n in rng.integers(0, 25, 13)]
    h, lens = port_compare.pad_lists(lists, CPU)
    want_m, want_n = pairwise_positional(jnp.asarray(h.numpy().view(np.uint64)),
                                         jnp.asarray(lens.numpy()))
    m, n = port_compare.all_pairs_positional(lists, device=CPU)
    assert np.array_equal(m, np.asarray(want_m)) and np.array_equal(n, np.asarray(want_n))
    assert m.sum() > np.trace(m)
    got = port_compare.positional_matches(h[:5], lens[:5], h[5:10], lens[5:10])
    want = positional_matches(*(jnp.asarray(x.numpy()) for x in (h[:5], lens[:5], h[5:10],
                                                                  lens[5:10])))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


def test_positional_rows_tiled(monkeypatch):
    rng = np.random.default_rng(32)
    lists = [rng.integers(0, 3, int(n)).astype(np.uint64) for n in rng.integers(1, 20, 9)]
    whole = port_compare.all_pairs_positional(lists, device=CPU)
    monkeypatch.setattr(port_compare, "_PLAIN_ELEMENTS", 50)
    tiled = port_compare.all_pairs_positional(lists, device=CPU)
    assert all(np.array_equal(a, b) for a, b in zip(whole, tiled))


def test_compare_fingerprints_copy_matches_jax():
    from fpmash_tpu.models.distance import compare_fingerprints

    rng = np.random.default_rng(33)
    for _ in range(10):
        a = rng.integers(0, 3, int(rng.integers(0, 12))).astype(np.uint64)
        b = rng.integers(0, 3, int(rng.integers(0, 12))).astype(np.uint64)
        for lim in ((1.0, 1.0), (0.5, 0.2)):
            assert port_distance.compare_fingerprints(a, b, *lim).__dict__ == \
                compare_fingerprints(a, b, *lim).__dict__


def test_compare_wrapper_dispatch_and_checks():
    ref = torch.tensor([[1, 2, 3]], dtype=torch.int64)
    lens = torch.tensor([3], dtype=torch.int32)
    before = compare_cuda.LAUNCHES
    c, d = compare_cuda.pairwise_common_denom(ref, lens, ref, lens, 10)
    assert compare_cuda.LAUNCHES == before  # the plain version is not a launch
    assert (c.tolist(), d.tolist()) == ([[3]], [[3]])
    with pytest.raises(ValueError, match="cpu or cuda"):
        compare_cuda.pairwise_common_denom(ref.to("meta"), lens.to("meta"), ref.to("meta"),
                                           lens.to("meta"), 10)
    with pytest.raises(ValueError, match="int32"):
        compare_cuda.pairwise_common_denom(ref, lens.to(torch.int64), ref, lens, 10)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["distinct", "repeats"])
def test_k9_matches_plain_on_card(cuda_device, rows):
    rng = np.random.default_rng(44)
    if rows == "distinct":
        ref, rl = _distinct_rows(rng, 37, 300, 0, 300)
        qry, ql = _distinct_rows(rng, 70, 300, 0, 300)
        qry[3], ql[3] = ref[5], rl[5]
    else:
        ref, rl = _repeat_rows(rng, 37, 90)
        qry, ql = _repeat_rows(rng, 70, 90)
    args = _args(ref, rl, qry, ql, cuda_device)
    for cap in (0, 1, 31, 32, 33, 100, 1000):
        before = compare_cuda.LAUNCHES
        got = compare_cuda.pairwise_common_denom(*args, cap)
        assert compare_cuda.LAUNCHES == before + 1
        want = port_compare.pairwise_common_denom(*args, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_k9_rows_wider_than_the_stage_on_card(cuda_device):
    """Rows of 5 000 hashes (wider than the 4 096 staged in shared memory)."""
    rng = np.random.default_rng(45)
    ref, rl = _distinct_rows(rng, 5, 5000, 3000, 5000)
    qry, ql = _distinct_rows(rng, 9, 5000, 0, 5000)
    qry[2], ql[2] = ref[1], rl[1]
    args = _args(ref, rl, qry, ql, cuda_device)
    for cap in (1000, 10000):
        got = compare_cuda.pairwise_common_denom(*args, cap)
        want = port_compare.pairwise_common_denom(*args, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
