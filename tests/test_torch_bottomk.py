"""Port: bottom-k selection (``ops/bottomk.py``) vs the JAX package and the numpy model.

The same hash pools, made with numpy from a seed (duplicates, invalid
lanes, values with the top bit set and real all-ones values, which both
packages treat as the pad), go through the JAX functions (XLA), the port's
torch versions and ``bottom_k_host``.  Every output is an integer or a
flag: the comparisons are exact.  The pools keep the JAX row-sort
compaction inside its capacity: where it overflows, the JAX function
reports ``ok`` false over a truncated candidate set, while the port has no
compaction and stays exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpmash_tpu.ops import bottomk as jbk
from fpmash_tpu_torch.ops import bottomk as bk

U32 = np.uint64(0xFFFFFFFF)
PAD = np.uint64(2**64 - 1)


def _pool(seed, n=1 << 14, distinct=6000):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**64, size=distinct, dtype=np.uint64)
    values[:3] = PAD
    pool = values[rng.integers(0, distinct, size=n)]
    valid = rng.random(n) > 0.05
    return pool, valid


def _planes(pool):
    return (pool & U32).astype(np.uint32), (pool >> np.uint64(32)).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _t32(x):
    return _t(x.view(np.int32))


def _same(mine, theirs, with_ok=True):
    values, counts, n = mine[:3]
    jv, jc, jn = (np.asarray(x) for x in theirs[:3])
    assert n == int(jn)
    assert np.array_equal(values.numpy().view(np.uint64), jv)
    assert np.array_equal(counts.numpy(), jc.astype(np.int64))
    if with_ok:
        assert mine[3] == bool(theirs[3])


@pytest.mark.parametrize("s,min_cov", [(64, 1), (200, 2), (7000, 1)])
def test_bottom_k_distinct_matches_jax_and_host(s, min_cov):
    pool, valid = _pool(s)
    mine = bk.bottom_k_distinct(_t(pool.view(np.int64)), _t(valid), s=s, min_cov=min_cov)
    _same(mine, jbk.bottom_k_distinct(jnp.asarray(pool), jnp.asarray(valid), s=s,
                                      min_cov=min_cov), with_ok=False)
    hv, hc = bk.bottom_k_host(pool[valid & (pool != PAD)], s, min_cov)
    n = mine[2]
    assert np.array_equal(mine[0][:n].numpy().view(np.uint64), hv)
    assert np.array_equal(mine[1][:n].numpy(), hc)
    jhv, jhc = jbk.bottom_k_host(pool[valid & (pool != PAD)], s, min_cov)
    assert np.array_equal(hv, jhv) and np.array_equal(hc, jhc)


@pytest.mark.parametrize(
    "s,min_cov,boost,need_counts",
    [(64, 1, 1, False), (64, 1, 1, True), (64, 2, 1, True), (300, 3, 2, True), (4000, 1, 1, False)],
)
def test_threshold_planes_matches_jax(s, min_cov, boost, need_counts):
    pool, valid = _pool(s + min_cov)
    lo, hi = _planes(pool)
    kw = dict(s=s, min_cov=min_cov, boost=boost, need_counts=need_counts)
    mine = bk.bottom_k_threshold_planes(_t32(lo), _t32(hi), _t(valid), **kw)
    _same(mine, jbk.bottom_k_threshold_planes(jnp.asarray(lo), jnp.asarray(hi),
                                              jnp.asarray(valid), **kw))
    # the u64 entry point is the same function of the joined pool
    mine64 = bk.bottom_k_threshold(_t(pool.view(np.int64)), _t(valid), **kw)
    _same(mine64, jbk.bottom_k_threshold(jnp.asarray(pool), jnp.asarray(valid), **kw))
    if mine[3]:  # ok: the exact bottom-s
        hv, hc = bk.bottom_k_host(pool[valid & (pool != PAD)], s, min_cov)
        assert np.array_equal(mine[0][: mine[2]].numpy().view(np.uint64), hv)
        if need_counts or min_cov > 1:
            assert np.array_equal(mine[1][: mine[2]].numpy(), hc)


@pytest.mark.parametrize(
    "s,min_cov,need_counts,collect_all,all_taken",
    [(64, 1, False, False, False), (64, 2, True, False, True), (500, 1, True, True, False),
     (8, 1, True, True, False)],
)
def test_premasked_planes_matches_jax(s, min_cov, need_counts, collect_all, all_taken):
    pool, valid = _pool(s * 3 + min_cov, distinct=800)
    # the producer's mask, sparse enough that the JAX row-sort compaction
    # (which the port does not have) keeps every survivor
    pool = np.where(valid & (pool < np.uint64(2**58)), pool, PAD)
    lo, hi = _planes(pool)
    mine = bk.bottom_k_premasked_planes(_t32(lo), _t32(hi), all_taken, s=s, min_cov=min_cov,
                                        need_counts=need_counts, collect_all=collect_all)
    extra = dict(expected_s=s) if collect_all else {}
    theirs = jbk.bottom_k_premasked_planes(
        jnp.asarray(lo), jnp.asarray(hi), jnp.bool_(all_taken), s=s, min_cov=min_cov,
        need_counts=need_counts, collect_all=collect_all, **extra)
    _same(mine, theirs)
    assert mine[2] > 0
    if collect_all:
        hv, hc = bk.bottom_k_host(pool[pool != PAD], s)
        n = mine[2]
        assert mine[3] == (len(np.unique(pool[pool != PAD])) <= s)
        assert np.array_equal(mine[0][:n].numpy().view(np.uint64), hv)
        assert np.array_equal(mine[1][:n].numpy(), hc)


def test_estimators_match_jax():
    rng = np.random.default_rng(4)
    values = np.sort(rng.integers(0, 2**64, size=1000, dtype=np.uint64))
    counts = rng.integers(1, 9, size=1000).astype(np.uint32)
    for s, bits in ((1000, 64), (999, 32), (2000, 64)):
        assert bk.estimate_set_size(values, s, bits) == jbk.estimate_set_size(values, s, bits)
    assert bk.estimate_set_size(np.zeros(5, np.uint64), 5) == 5.0
    assert bk.estimate_multiplicity(counts) == jbk.estimate_multiplicity(counts)
    assert bk.estimate_multiplicity(counts[:0]) == 0.0
