"""Port: the fingerprint kernels' wrappers (plain versions on the CPU) vs the JAX package.

The same windows, made with numpy from a seed, go through the Pallas kernels
behind ``fingerprint_hashes_fused`` in interpret mode (both packings and
both variants, as tests/test_fused_pallas.py runs them), through the JAX
split XLA route (``cfl_lengths_onehot`` + ``murmur3_u64_batch``), and
through ``fpmash_tpu_torch.ops.fused_cuda``'s ``fingerprint_hashes`` (K1's
window stream) and ``fingerprint_hashes_fused`` (the JAX signature: K1 or
K13 by variant) on CPU tensors.  Hashes and counts are integers: every
comparison is exact.

The tests marked ``gpu`` hold the kernels against their plain version on a
card; the test functions import JAX and the JAX package only inside the CPU
tests, so on a machine with a card and no JAX they run with ``python -m
pytest tests/test_torch_fingerprint.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import fused_cuda
from fpmash_tpu_torch.scalar.lyndon import cfl as port_cfl

L = 100


def _windows(seed: int, alphabet: bytes, n: int = 56) -> list[bytes]:
    """Full-width windows plus short, empty and degenerate rows."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(alphabet, np.uint8)
    words = [lut[rng.integers(0, len(lut), size=L)].tobytes() for _ in range(n)]
    words += [lut[rng.integers(0, len(lut), size=int(m))].tobytes()
              for m in rng.integers(1, L, size=4)]  # reads shorter than 100
    words += [b"", b"", b"A" * L, b"ACGT" * 25, b"T" * (L - 1) + b"A", b"C"]
    return words


def _rows(words):
    arr = np.zeros((len(words), L), np.uint8)
    lens = np.array([len(w) for w in words], np.int32)
    for i, w in enumerate(words):
        arr[i, : len(w)] = np.frombuffer(w, np.uint8)
    return arr, lens


def _stream(words):
    """The port's layout: one flat stream, a start and a length per window.
    Windows are packed back to back, except that empty ones share a start."""
    flat = np.frombuffer(b"".join(words), np.uint8).copy()
    starts = np.cumsum([0] + [len(w) for w in words[:-1]]).astype(np.int64)
    lens = np.array([len(w) for w in words], np.int32)
    return torch.from_numpy(flat), torch.from_numpy(starts), torch.from_numpy(lens)


def _port(words, seed=42):
    h1, h2, count = fused_cuda.fingerprint_hashes(*_stream(words), seed)
    return h1.numpy().view(np.uint64), h2.numpy().view(np.uint64), count.numpy()


@pytest.mark.parametrize(
    "pack,alphabet", [("byte4", b"ACGTNacgRY?"), ("dna16", b"ACGT")]
)
def test_fingerprint_matches_pallas_interpret(pack, alphabet):
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_fused

    words = _windows(3 if pack == "byte4" else 4, alphabet)
    arr, lens = _rows(words)
    jh1, jh2, jfc = fingerprint_hashes_fused(
        jnp.asarray(arr), jnp.asarray(lens), seed=42, interpret=True, pack=pack
    )
    h1, h2, count = _port(words)
    assert np.array_equal(h1, np.asarray(jh1))
    assert np.array_equal(h2, np.asarray(jh2))
    assert np.array_equal(count, np.asarray(jfc))


def test_fingerprint_matches_split_xla_route():
    """vs the JAX package's XLA formulation the kernel is held against."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.lyndon import cfl_lengths_onehot
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    words = _windows(5, b"ACGTN")
    arr, lens = _rows(words)
    fac_len, fac_count = cfl_lengths_onehot(jnp.asarray(arr), jnp.asarray(lens))
    jh1, jh2 = murmur3_u64_batch(fac_len.astype(jnp.uint64), fac_count, seed=42)
    h1, h2, count = _port(words)
    assert np.array_equal(h1, np.asarray(jh1))
    assert np.array_equal(h2, np.asarray(jh2))
    assert np.array_equal(count, np.asarray(fac_count))


@pytest.mark.parametrize("hash_seed", [42, 7])
def test_fingerprint_matches_scalar_chain(hash_seed):
    """vs Duval + MurmurHash3 one window at a time, and the port's CFL copy
    vs the JAX package's."""
    from fpmash_tpu.scalar.lyndon import cfl
    from fpmash_tpu.scalar.murmur3 import murmur3_x64_128

    words = _windows(6, b"ACGTN", n=24)
    h1, h2, count = _port(words, hash_seed)
    for i, w in enumerate(words):
        text = w.decode("latin-1")
        assert port_cfl(text) == cfl(text)
        vec = [len(f) for f in cfl(text)]
        data = b"".join(int(v).to_bytes(8, "little") for v in vec)
        assert (int(h1[i]), int(h2[i])) == murmur3_x64_128(data, hash_seed), i
        assert int(count[i]) == len(vec)


def test_overlapping_shift_windows_share_the_stream():
    """Cyclic windows of one read, as the sketch path ships them."""
    rng = np.random.default_rng(8)
    read = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=180)].tobytes()
    doubled = read + read[: L - 1]
    flat = torch.frombuffer(bytearray(doubled), dtype=torch.uint8)
    starts = torch.arange(len(read), dtype=torch.int64)
    lens = torch.full((len(read),), L, dtype=torch.int32)
    h1, _, count = fused_cuda.fingerprint_hashes(flat, starts, lens)
    want = _port([doubled[i : i + L] for i in range(len(read))])
    assert np.array_equal(h1.numpy().view(np.uint64), want[0])
    assert np.array_equal(count.numpy(), want[2])


def test_windows_outside_the_stream_are_flagged():
    flat = torch.zeros(5, dtype=torch.uint8)
    h1, h2, count = fused_cuda.fingerprint_hashes(
        flat,
        torch.tensor([0, 3, -1, 5, 2], dtype=torch.int64),
        torch.tensor([5, 3, 1, 0, -2], dtype=torch.int32),
    )
    assert count.tolist() == [5, -1, -1, 0, -1]
    assert h1.tolist()[1:3] == [0, 0] and h2.tolist()[4] == 0


def test_wrapper_dispatch_and_checks():
    flat, starts, lens = _stream([b"ACGT"])
    before = fused_cuda.LAUNCHES
    fused_cuda.fingerprint_hashes(flat, starts, lens)
    assert fused_cuda.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_cuda.fingerprint_hashes(flat.to("meta"), starts.to("meta"), lens.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        fused_cuda.fingerprint_hashes(flat, starts, lens.to(torch.int64))


# ---------------------------------------------------------------------- #
# the JAX function's own entry point: fingerprint_hashes_fused(variant=...)
# ---------------------------------------------------------------------- #


def _fused_rows(seed):
    """Rows of bytes with N, lowercase and other bytes, lengths 0, 1 and L."""
    words = _windows(seed, b"ACGTNacgRY?\x00\xff", n=40)
    words += [b"N" * L, b"ACGTN" * 20, b"TTTTNAAAAC"]
    return _rows(words)


@pytest.mark.parametrize("pack", ["byte4", "dna16"])
@pytest.mark.parametrize("variant", ["inline", "split"])
def test_fused_entry_point_matches_pallas_interpret(pack, variant):
    """Both variants under both packings, as the JAX function answers;
    under dna16 every byte but C, G and T compares as an A."""
    import jax.numpy as jnp

    from fpmash_tpu.ops.fused_pallas import fingerprint_hashes_fused

    arr, lens = _fused_rows(30)
    assert {0, 1, L} <= set(lens.tolist())
    jh1, jh2, jfc = fingerprint_hashes_fused(
        jnp.asarray(arr), jnp.asarray(lens), seed=42, interpret=True, pack=pack, variant=variant
    )
    h1, h2, count = fused_cuda.fingerprint_hashes_fused(
        torch.from_numpy(arr), torch.from_numpy(lens), 42, pack, variant)
    assert np.array_equal(h1.numpy().view(np.uint64), np.asarray(jh1))
    assert np.array_equal(h2.numpy().view(np.uint64), np.asarray(jh2))
    assert np.array_equal(count.numpy(), np.asarray(jfc))


def test_fused_entry_point_packs():
    """dna16 equals byte4 on rows whose bytes are mapped to A C G T first."""
    arr, lens = _fused_rows(31)
    dna = np.frombuffer(b"ACGT", np.uint8)[
        np.select([arr == ord("C"), arr == ord("G"), arr == ord("T")], [1, 2, 3], 0)]
    a = fused_cuda.fingerprint_hashes_fused(torch.from_numpy(arr), torch.from_numpy(lens),
                                            pack="dna16")
    b = fused_cuda.fingerprint_hashes_fused(torch.from_numpy(dna), torch.from_numpy(lens))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], fused_cuda.fingerprint_hashes_fused(
        torch.from_numpy(arr), torch.from_numpy(lens))[0])


def test_fused_entry_point_checks():
    arr, lens = _fused_rows(32)
    batch, n = torch.from_numpy(arr), torch.from_numpy(lens)
    before = (fused_cuda.LAUNCHES, fused_cuda.INLINE_LAUNCHES)
    fused_cuda.fingerprint_hashes_fused(batch, n, variant="inline")
    assert (fused_cuda.LAUNCHES, fused_cuda.INLINE_LAUNCHES) == before
    with pytest.raises(ValueError, match=r"lie in \[0, 100\]"):
        fused_cuda.fingerprint_hashes_fused(batch, n + 1)
    with pytest.raises(ValueError, match=r"lie in \[0, 100\]"):
        fused_cuda.fingerprint_hashes_fused(batch, n - 1)
    with pytest.raises(ValueError, match="pack"):
        fused_cuda.fingerprint_hashes_fused(batch, n, pack="dna2")
    with pytest.raises(ValueError, match="variant"):
        fused_cuda.fingerprint_hashes_fused(batch, n, variant="fused")
    with pytest.raises(ValueError, match="uint8"):
        fused_cuda.fingerprint_hashes_fused(batch.to(torch.int32), n)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_cuda.fingerprint_hashes_fused(batch.to("meta"), n.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pack", ["byte4", "dna16"])
def test_fused_entry_point_kernels_match_plain_on_card(cuda_device, pack):
    arr, lens = _fused_rows(33)
    batch = torch.from_numpy(arr).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    want = fused_cuda.fingerprint_hashes_fused_plain(batch, n, 42, pack)
    for variant in ("inline", "split"):
        before = (fused_cuda.LAUNCHES, fused_cuda.INLINE_LAUNCHES)
        got = fused_cuda.fingerprint_hashes_fused(batch, n, 42, pack, variant)
        step = (0, 1) if variant == "inline" else (1, 0)
        assert (fused_cuda.LAUNCHES, fused_cuda.INLINE_LAUNCHES) == tuple(
            b + s for b, s in zip(before, step))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------- #
# the kernels' routes on a card (csrc/fingerprint.cu; its steps are
# modelled in tests/test_torch_fingerprint_body.py)
# ---------------------------------------------------------------------- #


def _shift_windows(seed: int, read_lens, alphabet: bytes = b"ACGT"):
    """Shift windows of reads as models/sketch.py ships them: reads of 100
    or more give a window of 100 per base, shorter ones one window."""
    from fpmash_tpu_torch.models.fingerprint import window_stream

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(alphabet, np.uint8)
    texts = [lut[rng.integers(0, len(lut), size=int(n))].tobytes().decode("latin-1")
             for n in read_lens]
    flat, starts, lengths, _ = window_stream(texts, shift=True)
    return flat, starts, lengths


def _k1_matches_plain(flat, starts, lengths):
    before = fused_cuda.LAUNCHES
    got = fused_cuda.fingerprint_hashes(flat, starts, lengths, 42)
    assert fused_cuda.LAUNCHES == before + 1
    want = fused_cuda.fingerprint_hashes_plain(flat, starts, lengths, 42)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.gpu
def test_k1_shift_windows_across_blocks_and_reads_on_card(cuda_device):
    """Staged blocks: windows across block edges, read boundaries inside
    blocks, reads under 100 bases and of one base, N and bytes >= 0x80."""
    read_lens = [300, 99, 1, 517, 40, 100, 2, 2000, 257, 101]
    flat, starts, lengths = _shift_windows(41, read_lens, b"ACGTN\x80\xfe")
    args = [torch.from_numpy(a).to(cuda_device) for a in (flat, starts, lengths)]
    got = _k1_matches_plain(*args)
    assert bool((got[2] > 0).all())  # every window lies inside the stream


@pytest.mark.gpu
def test_k1_spans_over_the_cap_on_card(cuda_device):
    """Device-memory route: shuffled starts of a long stream, whole reads of
    300-5 000 bases, and blocks that mix staged and unstaged windows."""
    flat, starts, lengths = _shift_windows(42, [3000, 2500, 1800])
    order = np.random.default_rng(42).permutation(len(starts))
    flat_t = torch.from_numpy(flat).to(cuda_device)
    _k1_matches_plain(flat_t, torch.from_numpy(starts[order]).to(cuda_device),
                      torch.from_numpy(lengths[order]).to(cuda_device))
    rng = np.random.default_rng(43)
    reads = [np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=n)]
             for n in (300, 5000, 129, 128, 1024, 2, 4000)]
    whole = np.concatenate(reads)
    first = np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64)
    lens = np.array([len(r) for r in reads], np.int32)
    _k1_matches_plain(*(torch.from_numpy(a).to(cuda_device) for a in (whole, first, lens)))
    # 300 windows of one long read at stride 7, then shift windows: mixed blocks
    mixed_starts = np.concatenate([np.arange(300, dtype=np.int64) * 7, first[:3]])
    mixed_lens = np.concatenate([np.full(300, 100, np.int32), lens[:3]])
    _k1_matches_plain(*(torch.from_numpy(a).to(cuda_device)
                        for a in (whole, mixed_starts, mixed_lens)))


@pytest.mark.gpu
def test_k1_unaligned_stream_on_card(cuda_device):
    """A stream whose base is not 16-byte aligned (``flat[1:]``, contiguous),
    with windows at its very start and end and outside it."""
    flat, starts, lengths = _shift_windows(44, [700, 450, 60])
    buf = torch.from_numpy(np.concatenate([[7], flat]).astype(np.uint8)).to(cuda_device)
    view = buf[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    starts = np.concatenate([starts, [0, len(flat) - 5, len(flat) - 4, -3]]).astype(np.int64)
    lengths = np.concatenate([lengths, [len(flat), 5, 9, 2]]).astype(np.int32)
    got = _k1_matches_plain(view, torch.from_numpy(starts).to(cuda_device),
                            torch.from_numpy(lengths).to(cuda_device))
    assert got[2][-2:].tolist() == [-1, -1]


def _k13_matches_plain(batch, n, pack):
    before = fused_cuda.INLINE_LAUNCHES
    got = fused_cuda.fingerprint_hashes_fused(batch, n, 42, pack, "inline")
    assert fused_cuda.INLINE_LAUNCHES == before + 1
    want = fused_cuda.fingerprint_hashes_fused_plain(batch, n, 42, pack)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", ["byte4", "dna16"])
def test_k13_rows_routes_on_card(cuda_device, pack):
    """Rows of 100 (B = 1 001, not a multiple of any block; B = 1), an
    unaligned rows pointer, rows wider than the cap (129 and 300: device
    memory, dna16 mapped at the read) and of width 1; N, lower case and
    other bytes, which dna16 compares as A."""
    rng = np.random.default_rng(45)
    for width, B in ((100, 1001), (100, 1), (129, 300), (300, 257), (1, 40)):
        arr = np.frombuffer(b"ACGTNacgtRY\x00\xff", np.uint8)[
            rng.integers(0, 13, size=(B, width))].copy()
        arr[: B // 3] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B // 3, width))]
        lens = rng.integers(0, width + 1, size=B).astype(np.int32)
        lens[: B // 2] = width
        n = torch.from_numpy(lens).to(cuda_device)
        _k13_matches_plain(torch.from_numpy(arr).to(cuda_device), n, pack)
        buf = torch.from_numpy(np.concatenate([[0, 0, 0], arr.reshape(-1)]).astype(np.uint8))
        view = buf.to(cuda_device)[3:].view(B, width)
        assert view.is_contiguous() and view.data_ptr() % 16 == 3
        _k13_matches_plain(view, n, pack)
