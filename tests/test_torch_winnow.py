"""Port: the minmer selection (``ops/winnow.py``) and the per-position hashes
of windowed sketches (``models/sketch.position_hashes``).

The op is held against the JAX package's ``minmer_positions`` on both of its
routes (numpy, and the XLA jit) and against the reference's incremental
model (``scalar/winnow.py``), with hashes over the whole 64-bit range (half
of them at or above 2^63, where a signed sort would pick other minmers),
repeated hashes, and windows with fewer distinct values than ``mins``.  The
position hashes are held against the scalar MurmurHash3 of the raw bytes.

The tests marked ``gpu`` run the op and the hash route on the card against
their CPU runs; without a usable card they skip.  On the card machine (no
JAX there): ``python -m pytest tests/test_torch_winnow.py -m gpu
--noconftest``.  JAX is imported only inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models import sketch as port_sketch
from fpmash_tpu_torch.models.sketch import SketchParams, position_hashes
from fpmash_tpu_torch.ops import kmers_cuda, winnow
from fpmash_tpu_torch.ops.winnow import minmer_positions
from fpmash_tpu_torch.scalar.murmur3 import hash_bytes
from fpmash_tpu_torch.scalar.winnow import minmer_position_hashes

CPU = torch.device("cpu")
_MIX = np.uint64(0x9E3779B97F4A7C15)


def _hashes(rng, n: int, kind: str) -> np.ndarray:
    """u64 hashes of ``kind``: ``full`` uniform over 2^64, ``repeats`` 9
    values spread over the range, ``few`` 3 values, ``edges`` only 0, 5,
    2^63 and 2^64 - 1."""
    if kind == "full":
        return rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2) + \
            rng.integers(0, 2, size=n, dtype=np.uint64)
    if kind == "edges":
        return np.array([0, 5, 1 << 63, (1 << 64) - 1], np.uint64)[rng.integers(0, 4, size=n)]
    alpha = 9 if kind == "repeats" else 3
    return (rng.integers(1, alpha + 1, size=n).astype(np.uint64) * _MIX)


def _pairs(pos, ph):
    return list(zip(pos.tolist(), ph.tolist()))


def _port(h, ws, mins):
    return _pairs(*minmer_positions(h, ws, mins, device=CPU))


@pytest.mark.parametrize("kind", ["full", "repeats", "few"])
def test_minmer_op_matches_oracle_and_jax_numpy_route(kind):
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    rng = np.random.default_rng({"full": 1, "repeats": 2, "few": 3}[kind])
    for _ in range(60):
        n = int(rng.integers(1, 300))
        h = _hashes(rng, n, kind)
        ws = int(rng.integers(1, 80))
        mins = int(rng.integers(1, 12))
        got = _port(h, ws, mins)
        assert got == minmer_position_hashes([int(x) for x in h], ws, mins)
        assert got == _pairs(*jax_minmers(h, ws, mins, backend="scalar"))


@pytest.mark.parametrize("n,ws,mins", [(257, 31, 5), (400, 64, 70), (90, 200, 3)])
def test_minmer_op_matches_jax_device_route(n, ws, mins):
    """The XLA jit of the JAX package (its chunk clamps its starts to the
    last window; the port slices the last chunk)."""
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    rng = np.random.default_rng(n)
    for kind in ("full", "repeats"):
        h = _hashes(rng, n, kind)
        assert _port(h, ws, mins) == _pairs(*jax_minmers(h, ws, mins, backend="jax"))


def test_minmer_op_full_range_needs_unsigned_order():
    """Half of the hashes lie at or above 2^63: selecting by their signed
    order (the bits reinterpreted, as a plain int64 sort would) picks other
    minmers, so the tests above see the unsigned order."""
    rng = np.random.default_rng(4)
    h = _hashes(rng, 2000, "full")
    assert (h >= np.uint64(1 << 63)).mean() > 0.4
    flipped = h ^ np.uint64(1 << 63)  # unsigned order of these = signed order of h
    assert _port(h, 100, 8) != [(p, int(np.uint64(x) ^ np.uint64(1 << 63)))
                                for p, x in _port(flipped, 100, 8)]


def test_minmer_op_crosses_chunk_edges(monkeypatch):
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    rng = np.random.default_rng(3)
    h = _hashes(rng, 3000, "full")
    expect = minmer_position_hashes([int(x) for x in h], 2048, 5)
    assert _pairs(*jax_minmers(h, 2048, 5, backend="jax")) == expect
    for elems in (2048, 2048 * 7 + 5, 1 << 20):  # 1 start a chunk, 7 (last short), all
        monkeypatch.setitem(winnow.CHUNK_ELEMS, "cpu", elems)
        assert _port(h, 2048, 5) == expect
    h = _hashes(rng, 500, "repeats")
    expect = minmer_position_hashes([int(x) for x in h], 40, 3)
    for elems in (40, 41, 40 * 13, 40 * 461):
        monkeypatch.setitem(winnow.CHUNK_ELEMS, "cpu", elems)
        assert _port(h, 40, 3) == expect


def test_minmer_op_window_larger_than_positions_and_edges():
    from fpmash_tpu.ops.winnow import minmer_positions as jax_minmers

    rng = np.random.default_rng(5)
    h = _hashes(rng, 50, "full")
    for ws, mins in ((51, 4), (10_000, 4), (50, 50), (10_000, 100), (1, 1), (7, 0)):
        want = _pairs(*jax_minmers(h, ws, mins, backend="scalar"))
        assert _port(h, ws, mins) == want
        if mins >= 1:
            assert want == minmer_position_hashes([int(x) for x in h], ws, mins)
    assert _port(np.zeros(0, np.uint64), 10, 3) == []
    # a tensor input gives the same as its numpy values
    t = torch.from_numpy(h.view(np.int64).copy())
    assert _pairs(*minmer_positions(t, 9, 3, device=CPU)) == _port(h, 9, 3)


# --------------------------------------------------------------------- #
# per-position hashes
# --------------------------------------------------------------------- #


def _scalar_position_hashes(seq: bytes, k: int, seed: int, use64: bool) -> list[int]:
    return [hash_bytes(seq[i : i + k], seed=seed, use64=use64) for i in range(len(seq) - k + 1)]


def _mixed_seq(rng, n: int) -> bytes:
    """DNA with ``N``s, lower case, IUPAC and other bytes in runs and alone."""
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()
    for ch in b"NnacgtRY-*":
        b[rng.integers(0, n, size=max(1, n // 200))] = ch
    b[n // 3 : n // 3 + 40] = np.frombuffer(b"acgt" * 10, np.uint8)
    b[n // 2 : n // 2 + 25] = ord("N")
    return b.tobytes()


@pytest.mark.parametrize("k", [9, 15, 16, 17, 21, 32, 33])
def test_position_hashes_equal_scalar_murmur_of_raw_bytes(k):
    rng = np.random.default_rng(k)
    seq = _mixed_seq(rng, 700)
    p = SketchParams(kmer_size=k, seed=7)
    got = position_hashes(seq, p, CPU).numpy().view(np.uint64).tolist()
    assert got == _scalar_position_hashes(seq, k, 7, p.use64)
    assert p.use64 == (k > 16)
    # a str and its bytes hash alike; shorter than k gives nothing
    assert position_hashes(seq.decode(), p, CPU).tolist() == \
        position_hashes(seq, p, CPU).tolist()
    assert position_hashes(seq[: k - 1], p, CPU).numel() == 0


def test_position_hashes_equal_jax_scalar_route():
    from fpmash_tpu.models.sketch import SketchParams as JaxParams
    from fpmash_tpu.models.sketch import _position_hashes as jax_position_hashes

    rng = np.random.default_rng(11)
    seq = _mixed_seq(rng, 1500).decode()
    for k, alphabet in ((21, "ACGT"), (12, "ACGT"), (5, "ACDEFGHIKLMNPQRSTVWY")):
        p = SketchParams(kmer_size=k, alphabet=alphabet)
        want = jax_position_hashes(seq, JaxParams(kmer_size=k, alphabet=alphabet), "scalar")
        assert np.array_equal(position_hashes(seq, p, CPU).numpy().view(np.uint64), want)


def test_position_hashes_cross_chunk_edges(monkeypatch):
    rng = np.random.default_rng(12)
    seq = _mixed_seq(rng, 3001)
    for k, size in ((21, 64), (21, 1000), (16, 37), (32, 47)):
        monkeypatch.setitem(port_sketch._POSITION_CHUNK, "cpu", size)
        monkeypatch.setattr(port_sketch, "_REHASH_BATCH", 50)
        p = SketchParams(kmer_size=k)
        got = position_hashes(seq, p, CPU).numpy().view(np.uint64).tolist()
        assert got == _scalar_position_hashes(seq, k, 42, p.use64)


def test_jax_device_route_hashes_differ_on_n_and_lower_case():
    """The JAX package's device route hashes a byte outside upper-case ACGT
    as ``T`` (its packed codes); its scalar route, and the port, hash the
    raw bytes.  Pure ACGT gives the same hashes on both routes."""
    from fpmash_tpu.models.sketch import SketchParams as JaxParams
    from fpmash_tpu.models.sketch import _position_hashes as jax_position_hashes

    rng = np.random.default_rng(13)
    p = JaxParams(kmer_size=21, preserve_case=False)
    mixed = _mixed_seq(rng, 300).decode()
    dev = jax_position_hashes(mixed, p, "jax")
    scal = jax_position_hashes(mixed, p, "scalar")
    assert (dev != scal).sum() > 0
    port = position_hashes(mixed, SketchParams(), CPU).numpy().view(np.uint64)
    assert np.array_equal(port, scal)
    pure = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=300)].tobytes().decode()
    assert np.array_equal(jax_position_hashes(pure, p, "jax"),
                          jax_position_hashes(pure, p, "scalar"))


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["full", "repeats", "few", "edges"])
def test_minmer_op_on_card_equals_cpu(cuda_device, kind, monkeypatch):
    """The kernel (``csrc/winnow.cu``) against the plain version on the CPU,
    with no floor of blocks: windows of 1 and 2 positions, around
    ``TILE_MAX`` (tiles of half of it) and around twice it (full tiles),
    past the positions; mins 0, 1 and more than the values; a window of
    10 000 with mins 5 000; then a shared cap of 64 candidates in launches
    of 3 tiles, where mins 100 and 5 000 put every swept tile past it (the
    device-memory path)."""
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    rng = np.random.default_rng(21)
    h = _hashes(rng, 30_000, kind)
    t = winnow.TILE_MAX
    cases = [(1000, 10), (64, 70), (40_000, 100), (1, 1), (2, 1), (1000, 100), (10_000, 5000),
             (t - 1, 5), (t, 5), (t + 1, 5), (2 * t - 1, 5), (2 * t + 1, 5), (9000, 0), (300, 1)]
    for step, (cap, tiles) in enumerate(((winnow.SHARED_CAP, winnow.LAUNCH_TILES), (64, 3))):
        monkeypatch.setattr(winnow, "SHARED_CAP", cap)
        monkeypatch.setattr(winnow, "LAUNCH_TILES", tiles)
        for ws, mins in cases[: 7 if step else None]:
            before = winnow.LAUNCHES
            got = minmer_positions(h, ws, mins, device=cuda_device)
            assert winnow.LAUNCHES > before
            want = minmer_positions(h, ws, mins, device=CPU)
            assert _pairs(*got) == _pairs(*want), (ws, mins, cap)


def _card_equals_plain(h: np.ndarray, ws: int, mins: int, dev) -> None:
    """The kernel's marks on the card equal ``minmer_marks_plain``'s on the
    card, byte for byte, and the kernel launched."""
    ht = torch.from_numpy(np.ascontiguousarray(h, np.uint64).view(np.int64)).to(dev)
    prev = winnow.prev_occurrence(ht)
    before = winnow.LAUNCHES
    got = winnow.minmer_marks(ht, prev, ws, mins)
    assert winnow.LAUNCHES > before
    want = winnow.minmer_marks_plain(ht, prev, ws, mins).to(torch.uint8)
    assert torch.equal(got, want), (len(h), ws, mins, winnow.launch_plan(len(h), ws))


@pytest.mark.gpu
def test_minmer_query_shape_on_card(cuda_device):
    """A find query strand: 4 980 positions, the window clamped to them (one
    start, one block), at find's mins and others; and a few more positions
    than the window (a handful of one-start tiles)."""
    rng = np.random.default_rng(23)
    for kind in ("full", "repeats", "few"):
        h = _hashes(rng, 4980, kind)
        for mins in (100, 1, 0, 5000):
            _card_equals_plain(h, 4980, mins, cuda_device)
        _card_equals_plain(_hashes(rng, 4990, kind), 4980, 100, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("ws", [1, 2, 3])
def test_minmer_small_windows_on_card(cuda_device, ws, monkeypatch):
    """Windows of 1-3 positions: tiles of ``THREADS_MIN`` starts, more than
    the window (no core), and the same windows at one start a tile."""
    rng = np.random.default_rng(24 + ws)
    for tile_max, tile in ((winnow.TILE_MAX, winnow.THREADS_MIN), (1, 1)):
        monkeypatch.setattr(winnow, "TILE_MAX", tile_max)
        assert winnow.launch_plan(50_000, ws).tile == tile
        for kind in ("full", "repeats", "few", "edges"):
            h = _hashes(rng, 50_000, kind)
            for mins in (0, 1, 2, 5):
                _card_equals_plain(h, ws, mins, cuda_device)


@pytest.mark.gpu
def test_minmer_overflow_on_card(cuda_device, monkeypatch):
    """Tiles whose candidates overflow a shared cap of 64 (device-memory
    scratch, launches of 3 tiles); a crowded bin refined until it fits; and
    the span read in place past shared memory (a window of 50 000)."""
    rng = np.random.default_rng(25)
    with monkeypatch.context() as m:
        m.setattr(winnow, "SHARED_CAP", 64)
        m.setattr(winnow, "LAUNCH_TILES", 3)
        m.setattr(winnow, "MIN_BLOCKS", 1)
        for kind in ("full", "repeats", "few"):
            h = _hashes(rng, 40_000, kind)
            for ws, mins in ((1000, 10), (3000, 100), (500, 70), (200, 3)):
                assert winnow.launch_plan(len(h), ws).scratch_cap > 0
                _card_equals_plain(h, ws, mins, cuda_device)
    with monkeypatch.context() as m:
        m.setattr(winnow, "SHARED_CAP", 256)
        h = rng.integers(0, 1 << 20, size=60_000, dtype=np.uint64)
        h[::500] = np.uint64((1 << 64) - 8)
        _card_equals_plain(h, 800, 30, cuda_device)
    h = _hashes(rng, 300_000, "full")
    assert not winnow.launch_plan(len(h), 50_000).stage
    _card_equals_plain(h, 50_000, 100, cuda_device)


@pytest.mark.gpu
def test_minmer_low_complexity_on_card(cuda_device):
    """Few values: 3 (every span below mins values: all candidates marked),
    128 and 101 (cores at or just above mins values: T at the top, every
    repeat a candidate), a run of 3 values between random ones (cores below
    mins values in spans above), and 32-bit hashes (k <= 16)."""
    rng = np.random.default_rng(26)
    vals = rng.integers(0, 1 << 63, size=128, dtype=np.uint64)
    mixed = _hashes(rng, 200_000, "full")
    mixed[60_000:90_000] = _hashes(rng, 30_000, "few")
    narrow = rng.integers(0, 1 << 32, size=199_985, dtype=np.uint64)
    for h, ws, mins in ((_hashes(rng, 1_000_000, "few"), 10_000, 100),
                        (vals[rng.integers(0, 128, size=200_000)], 10_000, 100),
                        (vals[rng.integers(0, 101, size=200_000)], 10_000, 100),
                        (vals[rng.integers(0, 128, size=100_000)], 1000, 10),
                        (mixed, 10_000, 100), (narrow, 1000, 10)):
        _card_equals_plain(h, ws, mins, cuda_device)


@pytest.mark.gpu
def test_minmer_full_tiles_on_card(cuda_device, monkeypatch):
    """Tiles of up to ``TILE_MAX`` starts with no floor of blocks: 1, 2 and 4
    starts a thread, the bitonic network past a block of candidates, the
    chromosome's geometry on 400 000 positions."""
    rng = np.random.default_rng(27)
    monkeypatch.setattr(winnow, "MIN_BLOCKS", 1)
    seen = set()
    for n, ws, mins in ((400_000, 10_000, 100), (100_000, 1200, 40), (100_000, 1400, 40),
                        (100_000, 300, 250), (100_000, 40, 30)):
        seen.add(winnow.launch_plan(n, ws).starts)
        for kind in ("full", "repeats"):
            _card_equals_plain(_hashes(rng, n, kind), ws, mins, cuda_device)
    assert seen == {1, 2, 4}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 16, 21, 32, 33])
def test_position_hashes_on_card_equal_scalar_murmur(cuda_device, k, monkeypatch):
    rng = np.random.default_rng(22 + k)
    seq = _mixed_seq(rng, 5000)
    p = SketchParams(kmer_size=k)
    key = "planes_k16" if k <= 16 else "planes_k32"
    for size in (1 << 24, 1024):
        monkeypatch.setitem(port_sketch._POSITION_CHUNK, "cuda", size)
        before = kmers_cuda.LAUNCHES[key]
        got = position_hashes(seq, p, cuda_device).cpu().numpy().view(np.uint64).tolist()
        assert got == _scalar_position_hashes(seq, k, 42, p.use64)
        if k <= 32:
            assert kmers_cuda.LAUNCHES[key] > before
