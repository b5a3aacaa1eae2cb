"""Port: the multi-device layer (``fpmash_tpu_torch/parallel/``) against the JAX package.

The JAX side runs on the 8 virtual CPU devices that ``tests/conftest.py``
forces (``default_mesh(8)``, and ``visible_device_count() == 8`` for its
routes); the port runs on an explicit mesh of 8 CPU shards (``(CPU,) * 8``,
the ``devices`` of its routes), with the
kernels' plain versions.  The same numpy-seeded inputs go through both and
must agree bit for bit, and with the port's one-device run: row counts
below and not divisible by 8, zero-length rows, hashes at and above 2^63, a
real 2^64 - 1, values repeated across shards, shards smaller than ``s``.
A signed merge is shown to give another sketch on these inputs.

JAX is imported inside the CPU tests only, so that the ``gpu`` tests (4
shards on one card, and one shard a card where there are several) run
where JAX is not installed:
``python -m pytest tests/test_torch_parallel.py -m gpu --noconftest``.
"""

from functools import partial

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.device import resolve_devices
from fpmash_tpu_torch.ops import compare_cuda, fused_cuda, icfl_cuda, kmers_cuda, walk_cuda
from fpmash_tpu_torch.parallel import sharded

CPU = torch.device("cpu")
MESH8 = (CPU,) * 8
U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture
def jax_mesh(monkeypatch):
    import jax

    from fpmash_tpu.parallel.mesh import default_mesh as jax_default_mesh

    monkeypatch.delenv("FPMASH_DEVICES", raising=False)
    assert len(jax.devices()) >= 8, "tests/conftest.py forces 8 host devices"
    return jax_default_mesh(8)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _windows(rng, B, L=40, zero_rows=True):
    lut = np.frombuffer(b"ACGT", np.uint8)
    w = lut[rng.integers(0, 4, size=(B, L))]
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    if zero_rows:
        lens[::3] = 0
    return w, lens


# ---------------------------------------------------------------------- #
# meshes
# ---------------------------------------------------------------------- #


def test_default_mesh_and_visible_devices(monkeypatch):
    """``--device cpu`` is the CPU alone, whatever ``FPMASH_DEVICES`` says;
    other device types are refused."""
    monkeypatch.delenv("FPMASH_DEVICES", raising=False)
    assert resolve_devices("cpu") == (CPU,)
    assert resolve_devices(CPU) == (CPU,)
    monkeypatch.setenv("FPMASH_DEVICES", "8")
    assert resolve_devices("cpu") == (CPU,)
    with pytest.raises(RuntimeError, match="unsupported"):
        resolve_devices("meta")


@pytest.mark.parametrize("cards,cap,want", [(4, None, 4), (4, "2", 2), (4, "9", 4), (4, "0", 1),
                                            (1, None, 1), (2, " 1 ", 1)])
def test_fpmash_devices_caps_the_cards(monkeypatch, cards, cap, want):
    """``FPMASH_DEVICES`` caps the cards of ``cuda`` at the card count, as
    ``fpmash_tpu/parallel/sharded.py:38-52`` does; an explicit card is one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if cap is None:
        monkeypatch.delenv("FPMASH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("FPMASH_DEVICES", cap)
    assert resolve_devices("cuda") == tuple(torch.device("cuda", i) for i in range(want))
    if cards > 1:
        assert resolve_devices("cuda:1") == (torch.device("cuda:1"),)
    else:
        with pytest.raises(RuntimeError, match="visible"):
            resolve_devices("cuda:1")
    assert resolve_devices("cpu") == (CPU,)


@pytest.mark.parametrize("n,shards", [(0, 8), (3, 8), (8, 8), (13, 8), (64, 8), (5, 1)])
def test_row_blocks_cover_the_rows_in_order(n, shards):
    blocks = sharded.row_blocks(n, shards)
    assert len(blocks) <= shards
    assert [r for b0, b1 in blocks for r in range(b0, b1)] == list(range(n))
    assert all(b1 - b0 == -(-n // shards) for b0, b1 in blocks[:-1])


# ---------------------------------------------------------------------- #
# row shards and fingerprint hashes
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("B", [1, 3, 13, 64])
def test_shard_rows_matches_jax_and_one_device(jax_mesh, monkeypatch, B):
    """``shard_rows`` over K1's rows (B below 8, not divisible by 8, with
    zero-length rows) equals the JAX package's ``shard_rows`` on 8 devices
    and the port's one-device call; each shard with rows runs once."""
    import jax.numpy as jnp

    from fpmash_tpu.parallel import sharded as jax_sharded

    rng = np.random.default_rng(100 + B)
    w, lens = _windows(rng, B)
    calls = []

    def fn(wd, ld):
        calls.append(wd.shape[0])
        return fused_cuda.fingerprint_hashes_fused(wd, ld, 42)[0], ld * 2

    h8, twice = sharded.shard_rows(fn, (w, lens), MESH8)
    assert calls == [b1 - b0 for b0, b1 in sharded.row_blocks(B, 8)]
    h1, _ = sharded.shard_rows(fn, (w, lens), (CPU,))
    want = np.asarray(jax_sharded.shard_rows(
        partial(jax_sharded._fused_fingerprint_hashes, seed=42),
        (jnp.asarray(w), jnp.asarray(lens))))
    assert np.array_equal(_u64(h8), want)
    assert torch.equal(h8, h1)
    assert torch.equal(twice, torch.from_numpy(lens) * 2)


def test_sharded_fingerprint_hashes_matches_jax(jax_mesh):
    import jax.numpy as jnp

    from fpmash_tpu.parallel.sharded import sharded_fingerprint_hashes as jax_fn

    rng = np.random.default_rng(2)
    w, lens = _windows(rng, 64, zero_rows=False)
    got = sharded.sharded_fingerprint_hashes(MESH8, w, lens)
    want = np.asarray(jax_fn(jax_mesh, jnp.asarray(w), jnp.asarray(lens)))
    assert np.array_equal(_u64(got), want)
    assert torch.equal(got, sharded.sharded_fingerprint_hashes((CPU,), w, lens))


@pytest.mark.parametrize("n_windows", [1, 5, 77])
def test_shard_windows_ships_each_shard_its_span(n_windows):
    """Each shard gets the span of the stream its windows cover, starts
    rebased; results equal K1 (plain) over the whole stream."""
    from fpmash_tpu_torch.models.fingerprint import window_stream

    rng = np.random.default_rng(n_windows)
    lut = "ACGT"
    texts = ["".join(lut[i] for i in rng.integers(0, 4, size=n)) for n in (150, 0, 30, 101)]
    flat, starts, lengths, _ = window_stream(texts, True)
    starts, lengths = starts[:n_windows], lengths[:n_windows]
    spans = []

    def fn(f, st, ln, dev):
        spans.append((len(f), int(st.min()), int((st + ln).max())))
        h1, _, count = fused_cuda.fingerprint_hashes(
            torch.from_numpy(f.copy()).to(dev), torch.from_numpy(st).to(dev),
            torch.from_numpy(ln.copy()).to(dev), 42)
        return h1, count

    got = sharded.shard_windows(fn, flat, starts, lengths, MESH8)
    blocks = sharded.row_blocks(n_windows, 8)
    if len(blocks) > 1:
        want = [(int((starts[b0:b1] + lengths[b0:b1]).max() - starts[b0:b1].min()), 0,
                 int((starts[b0:b1] + lengths[b0:b1]).max() - starts[b0:b1].min()))
                for b0, b1 in blocks]
        assert spans == want
    else:
        assert spans == [(len(flat), int(starts.min()), int((starts + lengths).max()))]
    whole = fn(flat, starts, lengths, CPU)
    assert all(torch.equal(g, w) for g, w in zip(got, whole))


# ---------------------------------------------------------------------- #
# bottom-k merge
# ---------------------------------------------------------------------- #


def _pool_case(rng, case):
    N = 40 if case == "small-shards" else 4096
    pool = rng.integers(0, 2**64, size=N, dtype=np.uint64)  # half at or above 2^63
    valid = np.ones(N, bool)
    if case == "pad":
        pool[rng.choice(N, 7, replace=False)] = U64MAX  # a real 2^64 - 1 is the pad
    if case == "repeats":
        pool = rng.choice(pool[:300], size=N)  # values repeated across shards
    if case == "invalid":
        valid = rng.random(N) < 0.6
    return pool, valid


@pytest.mark.parametrize("case", ["high-bit", "pad", "repeats", "small-shards", "invalid"])
def test_sharded_bottom_k_matches_jax(jax_mesh, case):
    import jax.numpy as jnp

    from fpmash_tpu.parallel.sharded import sharded_bottom_k as jax_fn

    rng = np.random.default_rng(7)
    pool, valid = _pool_case(rng, case)
    s = 32 if case == "small-shards" else 200
    got = sharded.sharded_bottom_k(MESH8, pool, valid, s)
    want = np.asarray(jax_fn(jax_mesh, jnp.asarray(pool), jnp.asarray(valid), s))
    assert np.array_equal(_u64(got), want)
    assert torch.equal(got, sharded.sharded_bottom_k((CPU,), pool, valid, s))
    live = np.unique(pool[valid & (pool != U64MAX)])[:s]
    assert np.array_equal(_u64(got)[: len(live)], live)


def _signed_bottom_k(pool: torch.Tensor, s: int) -> torch.Tensor:
    """Bottom-s distinct values in *signed* order: the fault this layer avoids."""
    return torch.unique(pool[pool != -1], sorted=True)[:s]


def test_a_signed_merge_gives_another_sketch():
    """Half of all hashes lie at or above 2^63: a merge that compares the
    ``int64`` carriers as signed picks other values than the JAX package's
    unsigned one, which the port's sharded merge equals."""
    rng = np.random.default_rng(7)
    pool, valid = _pool_case(rng, "high-bit")
    t = torch.from_numpy(pool.view(np.int64))
    s = 200
    signed = _signed_bottom_k(torch.cat([_signed_bottom_k(t[b0:b1], s)
                                         for b0, b1 in sharded.row_blocks(len(t), 8)]), s)
    got = sharded.sharded_bottom_k(MESH8, pool, valid, s)
    assert np.array_equal(_u64(got), np.unique(pool)[:s])
    assert not np.array_equal(np.sort(_u64(signed)), _u64(got))


# ---------------------------------------------------------------------- #
# all-pairs tiles
# ---------------------------------------------------------------------- #


def _sorted_lists(rng, n, S):
    """Sorted distinct lists of varying lengths over the whole 64-bit range."""
    return [np.sort(np.unique(rng.integers(0, 2**64, size=int(rng.integers(0, S + 1)),
                                           dtype=np.uint64)))
            for _ in range(n)]


def _unsorted_lists(rng, n, S):
    """Lists in file order from a small pool (repeats), some with the high bit
    set, some holding a real 2^64 - 1, one empty."""
    out = []
    for i in range(n):
        a = rng.integers(0, 3 * S // 2, size=int(rng.integers(1, S + 1))).astype(np.uint64)
        if i % 3 == 0:
            a |= np.uint64(1 << 63)
        if i % 5 == 1:
            a[-1] = U64MAX
        out.append(a)
    out[-1] = out[-1][:0]
    return out


@pytest.mark.parametrize("R,Q", [(5, 13), (12, 3), (1, 1), (9, 16)])
def test_sharded_all_pairs_matches_jax(jax_mesh, R, Q):
    """K9 (plain) with the queries over 8 shards equals the JAX package's
    all-pairs route on 8 devices (which pads Q to the mesh), its
    ``sharded_all_pairs`` where Q divides, and one device."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.compare import all_pairs_common_denom as jax_route
    from fpmash_tpu.parallel.sharded import sharded_all_pairs as jax_fn
    from fpmash_tpu_torch.ops.walk import pad_lists

    rng = np.random.default_rng(R * 100 + Q)
    S, cap = 24, 20
    refs, qrys = _sorted_lists(rng, R, S), _sorted_lists(rng, Q, S)
    ref, rl = pad_lists(refs, CPU)
    qry, ql = pad_lists(qrys, CPU)
    got = sharded.sharded_all_pairs(MESH8, ref, rl, qry, ql, cap)
    want = jax_route(refs, qrys, cap)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    one = sharded.sharded_all_pairs((CPU,), ref, rl, qry, ql, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, one))
    if Q % 8 == 0:
        from fpmash_tpu.ops.compare import _pad_batch

        (jref, jrl), (jqry, jql) = _pad_batch(refs, S), _pad_batch(qrys, S)
        direct = jax_fn(jax_mesh, jnp.asarray(jref), jnp.asarray(jrl), jnp.asarray(jqry),
                        jnp.asarray(jql), cap)
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, direct))


@pytest.mark.parametrize("R,Q", [(7, 11), (3, 2), (16, 9)])
def test_sharded_all_pairs_walk_matches_jax(jax_mesh, R, Q):
    """K2 (plain) over 8 query shards equals the JAX walk route on 8 devices
    on unsorted lists with repeats, high bits, 2^64 - 1 and an empty list."""
    from fpmash_tpu.ops.walk import all_pairs_walk as jax_route
    from fpmash_tpu_torch.ops.walk import pad_lists

    rng = np.random.default_rng(R * 10 + Q)
    S, cap = 30, 25
    refs, qrys = _unsorted_lists(rng, R, S), _unsorted_lists(rng, Q, S)
    ref, rl = pad_lists(refs, CPU)
    qry, ql = pad_lists(qrys, CPU)
    got = sharded.sharded_all_pairs_walk(MESH8, ref, rl, qry, ql, cap, max_steps=32)
    want = jax_route(refs, qrys, cap)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    one = sharded.sharded_all_pairs_walk((CPU,), ref, rl, qry, ql, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, one))
    with pytest.raises(ValueError, match="max_steps"):
        sharded.sharded_all_pairs_walk(MESH8, ref, rl, qry, ql, cap, max_steps=1)


@pytest.mark.parametrize("N", [5, 13])
def test_sharded_all_pairs_positional_matches_jax(jax_mesh, N):
    from fpmash_tpu.ops.compare import all_pairs_positional as jax_route
    from fpmash_tpu_torch.ops.walk import pad_lists

    rng = np.random.default_rng(N)
    lists = _unsorted_lists(rng, N, 20)
    h, lens = pad_lists(lists, CPU)
    got = sharded.sharded_all_pairs_positional(MESH8, h, lens)
    want = jax_route(lists)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    one = sharded.sharded_all_pairs_positional((CPU,), h, lens)
    assert all(torch.equal(g, w) for g, w in zip(got, one))


@pytest.mark.parametrize("R", [16, 13])
def test_sharded_all_pairs_replicated_matches_jax(jax_mesh, R):
    """References over 8 shards, queries on each: equal to one device and,
    where R divides over the mesh, to the JAX function."""
    import jax.numpy as jnp

    from fpmash_tpu.parallel.sharded import sharded_all_pairs_replicated as jax_fn
    from fpmash_tpu_torch.ops.walk import pad_lists

    rng = np.random.default_rng(R)
    refs, qrys = _sorted_lists(rng, R, 16), _sorted_lists(rng, 3, 16)
    ref, rl = pad_lists(refs, CPU)
    qry, ql = pad_lists(qrys, CPU)
    got = sharded.sharded_all_pairs_replicated(MESH8, ref, rl, qry, ql, 12)
    one = sharded.sharded_all_pairs_replicated((CPU,), ref, rl, qry, ql, 12)
    assert all(torch.equal(g, w) for g, w in zip(got, one))
    if R % 8 == 0:
        from fpmash_tpu.ops.compare import _pad_batch

        (jref, jrl), (jqry, jql) = _pad_batch(refs, 16), _pad_batch(qrys, 16)
        want = jax_fn(jax_mesh, jnp.asarray(jref), jnp.asarray(jrl), jnp.asarray(jqry),
                      jnp.asarray(jql), 12)
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


def test_pipeline_step_matches_jax(jax_mesh):
    import jax.numpy as jnp

    from fpmash_tpu.parallel.sharded import pipeline_step as jax_fn

    rng = np.random.default_rng(0)
    w, lens = _windows(rng, 64, zero_rows=False)
    S = 8
    ref = np.sort(rng.integers(1, 1 << 40, (8, S), dtype=np.uint64), axis=1)
    ref[0, :2] = np.sort(_u64(sharded.sharded_fingerprint_hashes((CPU,), w, lens)))[:2]
    ref[0] = np.sort(ref[0])
    rl = np.full(8, S, np.int32)
    got = sharded.pipeline_step(MESH8, w, lens, ref, rl, sketch_size=S)
    want = jax_fn(jax_mesh, jnp.asarray(w), jnp.asarray(lens), jnp.asarray(ref), jnp.asarray(rl),
                  sketch_size=S)
    assert np.array_equal(_u64(got[0]), np.asarray(want[0]))
    assert all(np.array_equal(g.numpy(), np.asarray(x)) for g, x in zip(got[1:], want[1:]))
    assert int(got[1][0, 0]) >= 1  # the planted hashes are found
    one = sharded.pipeline_step((CPU,), w, lens, ref, rl, sketch_size=S)
    assert all(torch.equal(g, x) for g, x in zip(got, one))


# ---------------------------------------------------------------------- #
# on the card: 4 shards on one card, and one shard a card where there are several
# ---------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda:0")


def _card_checks(mesh, shards):
    """K1, K3 + K4, K5/K6 chunks, K2 and K9 over ``mesh`` against one card;
    each kernel launched once a shard (K1, K3, K4, K9, K2) or once a chunk."""
    from fpmash_tpu_torch.models import sketch as port_sketch
    from fpmash_tpu_torch.models.sketch import Sketch, SketchParams
    from fpmash_tpu_torch.ops.walk import pad_lists

    one = (mesh[0],)
    rng = np.random.default_rng(31)
    lut = "ACGT"
    reads = [(f"r{i}", "".join(lut[j] for j in rng.integers(0, 4, size=int(n))))
             for i, n in enumerate(rng.integers(60, 700, size=23))]
    for family, counter in (("CFL", lambda: fused_cuda.LAUNCHES),
                            ("ICFL_COMB", lambda: icfl_cuda.LAUNCHES["icfl"]
                             + icfl_cuda.LAUNCHES["hash_words"])):
        out = []
        for m in (one, mesh):
            sk = Sketch(SketchParams().for_fingerprint())
            before = counter()
            sk.init_from_reads_fingerprint(reads, family, devices=m)
            out.append(([r.hashes for r in sk.references], counter() - before))
        assert all(np.array_equal(a, b) for a, b in zip(out[0][0], out[1][0])), family
        assert out[1][1] == out[0][1] * shards, family

    seq = "".join(lut[j] for j in rng.integers(0, 4, size=60_000))
    saved = port_sketch._DIRECT_CHUNK
    port_sketch._DIRECT_CHUNK = 8192
    try:
        for s, key in ((2, "topk8"), (1000, "masked")):
            p = SketchParams(sketch_size=s)
            before = kmers_cuda.LAUNCHES[key]
            a = port_sketch._sketch_pools([seq], p, one)
            b = port_sketch._sketch_pools([seq], p, mesh)
            assert kmers_cuda.LAUNCHES[key] - before >= 16  # 8 chunks, twice
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), key
    finally:
        port_sketch._DIRECT_CHUNK = saved

    S = 64
    lists = [np.sort(np.unique(rng.integers(0, 2**64, size=S, dtype=np.uint64)))
             for _ in range(37)]
    ref, rl = pad_lists(lists[:21], mesh[0])
    qry, ql = pad_lists(lists[21:], mesh[0])
    for fn, counter in ((sharded.sharded_all_pairs, lambda: compare_cuda.LAUNCHES),
                        (sharded.sharded_all_pairs_walk, lambda: walk_cuda.LAUNCHES)):
        before = counter()
        got = fn(mesh, ref, rl, qry, ql, 50)
        assert counter() - before == shards
        want = fn(one, ref, rl, qry, ql, 50)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[0].device == mesh[0]


@pytest.mark.gpu
def test_four_shards_on_one_card_equal_one_shard(cuda_device):
    _card_checks((cuda_device,) * 4, 4)


@pytest.mark.gpu
def test_one_shard_a_card_equals_one_card(cuda_device):
    """Where there are several cards, one shard a card: each launch enters
    its card and stream (the per-device shapes and shared-memory opt-ins of
    the kernels hold on every card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    mesh = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    _card_checks(mesh, len(mesh))
