"""Port: the sorted all-pairs comparison K9 (plain version on the CPU) vs the JAX package.

The same sorted hash lists, made with numpy from a seed, go through the JAX
package's XLA formulation (``fpmash_tpu.ops.compare.pairwise_common_denom``),
its Pallas kernel in interpret mode (as ``tests/test_compare_pallas.py`` runs
it) and the port's plain version of K9: distinct lists with pads, lists with
repeated hashes, a real ``2^64 - 1`` hash, empty lists, caps below and above
the list widths.  ``dist`` on sorted lists with repeats is pinned against the
literal walk and the JAX package's host route (the port takes K9 only where
it equals the walk, as ``triangle`` does), and the positional comparison of
``triangle -fp`` against ``pairwise_positional``.  Counts are integers: exact.

JAX is imported inside the CPU tests only, so that the ``gpu`` tests (K9
against its plain version on the card) run where JAX is not installed:
``python -m pytest tests/test_torch_compare.py -m gpu --noconftest``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models import distance as port_distance
from fpmash_tpu_torch.models.sketch import sketch_from_arrays
from fpmash_tpu_torch.ops import compare as port_compare
from fpmash_tpu_torch.ops import compare_cuda
from fpmash_tpu_torch.ops.walk import pad_lists

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
        c, d = port_distance.all_pairs_common_denom(refs, qrys, cap, devices=(CPU,))
        for ri, A in enumerate(refs):
            for qi, B in enumerate(qrys):
                res = compare_sketches(A, B, 1, 1, cap, 21, 4.0**21)
                assert (c[ri, qi], d[ri, qi]) == (res.numer, res.denom)


def test_the_issue_example_differs_from_the_walk():
    """A = [5, 5, 9], B = [5, 7]: the union merge gives 2/3, the walk 1/4."""
    A, B = np.array([5, 5, 9], np.uint64), np.array([5, 7], np.uint64)
    c, d = port_distance.all_pairs_common_denom([A], [B], 1000, devices=(CPU,))
    assert (int(c[0, 0]), int(d[0, 0])) == (2, 3)
    res = port_distance.compare_sketches(A, B, 1, 1, 1000, 21, 4.0**21)
    assert (res.numer, res.denom) == (1, 4)


def test_all_pairs_common_denom_tiles_rows(monkeypatch):
    """Row blocks of a few pairs give the untiled result and the JAX host wrapper's."""
    from fpmash_tpu.ops.compare import all_pairs_common_denom as jax_all_pairs

    rng = np.random.default_rng(4)
    refs = [np.sort(rng.integers(0, 300, int(n)).astype(np.uint64)) for n in rng.integers(0, 60, 11)]
    qrys = [np.sort(rng.integers(0, 300, int(n)).astype(np.uint64)) for n in rng.integers(0, 60, 5)]
    whole = port_distance.all_pairs_common_denom(refs, qrys, 40, devices=(CPU,))
    monkeypatch.setattr(port_distance, "_TILE_PAIRS", 7)
    monkeypatch.setattr(port_compare, "_PLAIN_ELEMENTS", 300)
    tiled = port_distance.all_pairs_common_denom(refs, qrys, 40, devices=(CPU,))
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


def _jax_sketch(params, refs):
    import fpmash_tpu.models.sketch as jax_sketch

    sk = jax_sketch.Sketch(jax_sketch.SketchParams(**params))
    sk.references = [jax_sketch.Reference(**r) for r in refs]
    return sk


def _k9_calls(monkeypatch):
    calls = []
    orig = compare_cuda.pairwise_common_denom
    monkeypatch.setattr(compare_cuda, "pairwise_common_denom",
                        lambda *a: calls.append(1) or orig(*a))
    return calls


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted-repeats", "unsorted"])
def test_dist_matches_jax_device_route(monkeypatch, sorted_):
    """8 x 8 lists with repeated hashes (64 pairs, where the JAX package
    turns to its device route): the port's ``all_pairs_dist`` gives the
    literal walk's counts on every pair and takes the walk K2, not K9,
    whose multiset counts differ on repeats; at 7 x 8 it equals
    ``fpmash_tpu.models.distance.all_pairs_dist(backend="auto")`` (the JAX
    host walk).  On unsorted lists both JAX routes walk, and so does the
    port."""
    import fpmash_tpu.models.distance as jax_distance

    rng = np.random.default_rng(8)
    p_ref, r_ref = _sketches(rng, 8, 40, sorted_)
    p_qry, r_qry = _sketches(rng, 8, 30, sorted_)
    calls = _k9_calls(monkeypatch)
    port = list(port_distance.all_pairs_dist(
        sketch_from_arrays(p_ref, r_ref), sketch_from_arrays(p_qry, r_qry), devices=(CPU,)))
    assert not calls
    walk = [port_distance.compare_sketches(r["hashes"], q["hashes"], r["length"], q["length"],
                                           30, 21, 4.0**21)
            for q in r_qry for r in r_ref]
    assert [r.__dict__ for _, _, r in port] == [w.__dict__ for w in walk]
    if sorted_:  # on repeats K9 would have printed other counts
        k9 = port_distance.all_pairs_common_denom([r["hashes"] for r in r_ref],
                                                  [q["hashes"] for q in r_qry], 30,
                                                  devices=(CPU,))
        assert any((w.numer, w.denom) != (int(k9[0][ri, qi]), int(k9[1][ri, qi]))
                   for (ri, qi, _), w in zip(port, walk))
    else:
        jax = list(jax_distance.all_pairs_dist(_jax_sketch(p_ref, r_ref),
                                               _jax_sketch(p_qry, r_qry), backend="jax"))
        assert [(ri, qi, r.__dict__) for ri, qi, r in port] == \
               [(ri, qi, r.__dict__) for ri, qi, r in jax]

    small = list(port_distance.all_pairs_dist(
        sketch_from_arrays(p_ref, r_ref[:7]), sketch_from_arrays(p_qry, r_qry),
        devices=(CPU,)))
    jax = list(jax_distance.all_pairs_dist(_jax_sketch(p_ref, r_ref[:7]),
                                           _jax_sketch(p_qry, r_qry), backend="auto"))
    assert [(ri, qi, r.__dict__) for ri, qi, r in small] == \
           [(ri, qi, r.__dict__) for ri, qi, r in jax]


def test_dist_fp_on_poly_a_reads_matches_the_walk(tmp_path, capsys):
    """Poly-A reads: every window has the same fingerprint, so each list is
    one hash repeated.  ``dist -fp`` prints the walk's 130/150 and 120/130,
    the JAX CLI's lines, and never common above denom."""
    from fpmash_tpu.cli import main as jax_main
    from fpmash_tpu_torch.cli import main as port_main

    (tmp_path / "a.fasta").write_text(f">r1\n{'A' * 150}\n>r2\n{'A' * 120}\n")
    (tmp_path / "b.fasta").write_text(f">q1\n{'A' * 130}\n")
    for tag in ("a", "b"):
        assert port_main(["sketch", "--direct-fp", str(tmp_path / f"{tag}.fasta"),
                          "-o", str(tmp_path / tag.upper()), "--device", "cpu"]) == 0
    args = ["dist", "-fp", str(tmp_path / "A.msh"), str(tmp_path / "B.msh")]
    capsys.readouterr()
    assert port_main([*args, "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_main(args) == 0
    assert port == capsys.readouterr().out
    assert [line.split("\t")[4] for line in port.splitlines()] == ["130/150", "120/130"]
    assert all(float(line.split("\t")[2]) >= 0 for line in port.splitlines())


def _route_lists(kind):
    """Hash lists for ``kind``: strictly increasing (K9), one with a
    repeated hash, or one ending in 2^64 - 1 (K9's pad)."""
    rng = np.random.default_rng(12)
    lists = [np.sort(rng.choice(10**6, 50, replace=False)).astype(np.uint64) for _ in range(5)]
    if kind == "repeat":
        lists[2] = np.sort(np.concatenate([lists[2][:-1], lists[2][:1]]))
    elif kind == "pad":
        lists[3][-1] = U64MAX
    return lists


@pytest.mark.parametrize("kind", ["strict", "repeat", "pad"])
def test_dist_and_triangle_route_alike(tmp_path, monkeypatch, kind):
    """``dist`` and ``triangle`` take K9 on the same lists, both through
    ``k9_equals_walk``, and print the walk's counts."""
    from fpmash_tpu_torch.cli import main as port_main

    lists = _route_lists(kind)
    refs = [dict(name=f"s{i}", comment="", length=5000, hashes=h) for i, h in enumerate(lists)]
    sketch_from_arrays(dict(kmer_size=21, sketch_size=1000), refs).write_msh(
        str(tmp_path / "s.msh"))
    assert port_distance.k9_equals_walk(lists) == (kind == "strict")
    calls = _k9_calls(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()) as dist_out:
        assert port_main(["dist", str(tmp_path / "s.msh"), str(tmp_path / "s.msh"),
                          "--device", "cpu"]) == 0
    dist_k9 = len(calls)
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main(["triangle", str(tmp_path / "s.msh"), "--device", "cpu"]) == 0
    assert dist_k9 == len(calls) - dist_k9 == int(kind == "strict")
    for line in dist_out.getvalue().splitlines():
        r, q, *_, counts = line.split("\t")
        res = port_distance.compare_sketches(lists[int(r[1:])], lists[int(q[1:])], 1, 1, 1000,
                                             21, 4.0**21)
        assert counts == f"{res.numer}/{res.denom}"


def test_positional_matches_jax():
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import pairwise_positional, positional_matches

    rng = np.random.default_rng(31)
    lists = [rng.integers(0, 4, int(n)).astype(np.uint64) for n in rng.integers(0, 25, 13)]
    h, lens = pad_lists(lists, CPU)
    want_m, want_n = pairwise_positional(jnp.asarray(h.numpy().view(np.uint64)),
                                         jnp.asarray(lens.numpy()))
    m, n = port_distance.all_pairs_positional(lists, devices=(CPU,))
    assert np.array_equal(m, np.asarray(want_m)) and np.array_equal(n, np.asarray(want_n))
    assert m.sum() > np.trace(m)
    got = port_compare.positional_matches(h[:5], lens[:5], h[5:10], lens[5:10])
    want = positional_matches(*(jnp.asarray(x.numpy()) for x in (h[:5], lens[:5], h[5:10],
                                                                  lens[5:10])))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


def test_positional_rows_tiled(monkeypatch):
    rng = np.random.default_rng(32)
    lists = [rng.integers(0, 3, int(n)).astype(np.uint64) for n in rng.integers(1, 20, 9)]
    whole = port_distance.all_pairs_positional(lists, devices=(CPU,))
    monkeypatch.setattr(port_compare, "_PLAIN_ELEMENTS", 50)
    tiled = port_distance.all_pairs_positional(lists, devices=(CPU,))
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


#: merged elements the kernel's warp takes a step (kW in csrc/compare.cu)
K9_STEP = 512


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["distinct", "repeats"])
def test_k9_step_edges_on_card(cuda_device, rows):
    """Caps one below, at and one above the kernel's step, lengths off its
    multiples, empty lists on either side, and Q = 100 queries (two query
    groups of 50 a reference)."""
    rng = np.random.default_rng(46)
    s = K9_STEP
    if rows == "distinct":
        ref, rl = _distinct_rows(rng, 11, 1200, 0, 1200)
        qry, ql = _distinct_rows(rng, 100, 1200, 0, 1200)
        qry[3], ql[3] = ref[5], rl[5]
    else:
        ref, rl = _repeat_rows(rng, 11, 1200)
        qry, ql = _repeat_rows(rng, 100, 1200)
    rl[:6] = [0, s - 1, s, s + 1, 2 * s + 3, 1200]
    ql[:6] = [s + 1, 0, s - 1, s, 1200, 3 * s - 7]
    args = _args(ref, rl, qry, ql, cuda_device)
    for cap in (s - 1, s, s + 1, 2 * s + 1):
        got = compare_cuda.pairwise_common_denom(*args, cap)
        want = port_compare.pairwise_common_denom(*args, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[0].sum()) > 0
