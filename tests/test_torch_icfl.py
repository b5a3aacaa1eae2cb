"""Port: kernels K3/K14 (``factor_words``) and K4 (``hash_words``) and their plain versions.

On the CPU the plain versions are held against the JAX package: the Pallas
ICFL kernel ``icfl_words_fused`` and the hash kernel
``hash_from_words_fused`` in interpret mode (at rows of up to 44
characters, as ``tests/test_icfl_pallas.py`` runs them: interpret-mode
loops are slow), the XLA ``murmur3_u64_batch`` of the factor lengths, and
the per-row COMB flip ``_flip_mask(uniform=False)``.  Inputs are made with
numpy from a seed; every comparison is exact (words, hashes and counts are
integers).  The tests marked ``gpu`` hold each kernel against its plain
version on the card and skip without one.  JAX is imported inside the CPU
tests only, so that this file also runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.models.fingerprint import window_stream
from fpmash_tpu_torch.ops import icfl_cuda
from fpmash_tpu_torch.ops.factorize import FAMILY_PLANS, _flip_mask
from fpmash_tpu_torch.scalar.lyndon import FACTORIZATIONS


def _texts(seed: int, n: int = 48, max_len: int = 44) -> list[str]:
    """Random rows over several alphabets plus degenerate and periodic rows
    (two-letter and periodic rows force long border chains and many levels)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lut = np.frombuffer([b"ACGT", b"AC", b"ACGTN", b"ACGTACGTN?"][rng.integers(0, 4)], np.uint8)
        out.append(lut[rng.integers(0, len(lut), size=int(rng.integers(1, max_len + 1)))]
                   .tobytes().decode())
    pad = max_len // 4 + 1
    return out + ["A" * max_len, ("ACGT" * pad)[:max_len], "T" * (max_len - 1) + "A", "C", "",
                  ("ACACGTGT" * pad)[:max_len], ("AC" * max_len)[:max_len],
                  ("CCGCG" * pad)[:max_len - 1]]


def _stream(texts):
    flat, starts, lengths, _ = window_stream(texts, shift=False)
    return torch.from_numpy(flat), torch.from_numpy(starts), torch.from_numpy(lengths)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def test_plain_icfl_words_match_pallas_interpret():
    import jax.numpy as jnp

    from fpmash_tpu.ops.icfl_pallas import icfl_words_fused
    from fpmash_tpu.ops.lyndon import encode_batch

    texts = [t for t in _texts(31) if t]
    arr, lens = encode_batch(texts)
    jwords, jok = icfl_words_fused(jnp.asarray(arr), jnp.asarray(lens), pack="byte4",
                                   interpret=True)
    jwords, jok = np.asarray(jwords), np.asarray(jok)
    words, ok = icfl_cuda.factor_words_plain(*_stream(texts), "ICFL")
    assert jok.all() and bool(ok.all())
    W = words.shape[1]
    assert np.array_equal(_u32(words), jwords[:, :W])
    assert not jwords[:, W:].any()


def test_plain_hash_words_match_pallas_interpret_and_xla():
    import jax.numpy as jnp

    from fpmash_tpu.ops.icfl_pallas import hash_from_words_fused
    from fpmash_tpu.ops.lyndon import encode_batch, lengths_from_boundary, unpack_boundary_words
    from fpmash_tpu.ops.murmur3 import murmur3_u64_batch

    texts = _texts(32)
    flat, starts, lengths = _stream(texts)
    words, _ = icfl_cuda.factor_words_plain(flat, starts, lengths, "ICFL_COMB")
    h1, h2, count = icfl_cuda.hash_words_plain(words, lengths, 42)
    h1, h2 = h1.numpy().view(np.uint64), h2.numpy().view(np.uint64)

    padded = np.zeros((len(texts), 4), np.uint32)
    padded[:, : words.shape[1]] = _u32(words)
    jh1, jh2, jcnt = hash_from_words_fused(jnp.asarray(padded), jnp.asarray(lengths.numpy()),
                                           seed=42, interpret=True)
    assert np.array_equal(h1, np.asarray(jh1))
    assert np.array_equal(h2, np.asarray(jh2))
    assert np.array_equal(count.numpy(), np.asarray(jcnt))

    n = jnp.asarray(lengths.numpy())
    mask = unpack_boundary_words(jnp.asarray(padded), n)
    fac_len, fac_count = lengths_from_boundary(mask, n)
    xh1, xh2 = murmur3_u64_batch(fac_len.astype(jnp.uint64), fac_count, seed=42)
    assert np.array_equal(h1, np.asarray(xh1)) and np.array_equal(h2, np.asarray(xh2))
    _, arr_lens = encode_batch(texts)
    fam = FACTORIZATIONS["ICFL_COMB"]
    assert count.tolist() == [len(fam(t)) if t else 0 for t in texts]
    assert np.array_equal(arr_lens, lengths.numpy())


@pytest.mark.parametrize("seed", [5, 6])
def test_flip_mask_per_row_matches_jax(seed):
    import jax.numpy as jnp

    from fpmash_tpu.ops.factorize import _flip_mask as jax_flip_mask

    rng = np.random.default_rng(seed)
    B, L = 64, 100
    mask = rng.random((B, L)) < 0.3
    n = rng.integers(0, L + 1, size=B).astype(np.int32)
    n[:3] = [0, 1, L]
    mask &= np.arange(L)[None, :] < n[:, None]
    want = np.asarray(jax_flip_mask(jnp.asarray(mask), jnp.asarray(n), uniform=False))
    got = _flip_mask(torch.from_numpy(mask), torch.from_numpy(n).to(torch.int64))
    assert np.array_equal(got.numpy(), want)


def test_hash_words_plain_reads_only_cuts_below_n():
    """Bit 0 and bits at or past ``n`` do not change the hash; invalid
    lengths are flagged as K1 flags windows outside the stream."""
    words = torch.tensor([[0b10110, 0], [0b10111, -1], [0, 0], [5, 0]], dtype=torch.int32)
    lengths = torch.tensor([6, 6, 0, -1], dtype=torch.int32)
    h1, h2, count = icfl_cuda.hash_words_plain(words, lengths, 42)
    assert count.tolist() == [4, 4, 0, -1]  # cuts at 1, 2, 4: lengths 1 1 2 2
    assert h1[0] == h1[1] and h2[0] == h2[1]
    assert h1[3] == 0 and h2[3] == 0


def test_factor_words_wrapper_dispatch_and_checks():
    flat, starts, lengths = _stream(["ACGTACGT", "TTA"])
    before = dict(icfl_cuda.LAUNCHES)
    words, ok = icfl_cuda.factor_words(flat, starts, lengths, "ICFL_COMB")
    icfl_cuda.hash_words(words, lengths)
    assert icfl_cuda.LAUNCHES == before  # the plain versions are not launches
    with pytest.raises(ValueError, match="expected one of"):
        icfl_cuda.factor_words(flat, starts, lengths, "LYNDON")
    with pytest.raises(ValueError, match="cpu or cuda"):
        icfl_cuda.factor_words(flat.to("meta"), starts.to("meta"), lengths.to("meta"), "ICFL")
    with pytest.raises(ValueError, match="int32"):
        icfl_cuda.hash_words(words.to(torch.int64), lengths)
    # a window outside the stream: zero words, ok false
    words, ok = icfl_cuda.factor_words(flat, torch.tensor([0, 9]), torch.tensor([8, 5], dtype=torch.int32), "CFL")
    assert ok.tolist() == [True, False] and words[1].tolist() == [0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


def _card_texts(rng, n_rows: int, lo: int, hi: int) -> list[str]:
    out = []
    for k in range(n_rows):
        m = int(rng.integers(lo, hi + 1))
        if k % 9 == 8:
            out.append(("ACACGTGT" * (m // 8 + 1))[:m])
        else:
            lut = np.frombuffer(b"ACGTN" if k % 3 == 1 else b"ACGT", np.uint8)
            out.append(lut[rng.integers(0, len(lut), size=m)].tobytes().decode())
    return out + [""]


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0, 100), (101, 128), (129, 1023), (1024, 2100)],
                         ids=["narrow", "edge128", "wide", "cfl_only"])
def test_factor_and_hash_kernels_match_plain_on_card(cuda_device, lo, hi):
    rng = np.random.default_rng(lo)
    args = [t.to(cuda_device) for t in _stream(_card_texts(rng, 300, lo, hi))]
    for family, (base, _, _) in FAMILY_PLANS.items():
        if hi > icfl_cuda.MAX_ICFL_WIDTH and base != "cfl":
            with pytest.raises(ValueError, match="scalar model"):
                icfl_cuda.factor_words(*args, family)
            continue
        before = dict(icfl_cuda.LAUNCHES)
        words, ok = icfl_cuda.factor_words(*args, family)
        assert icfl_cuda.LAUNCHES[base] == before[base] + 1
        want_words, want_ok = icfl_cuda.factor_words_plain(*args, family)
        assert torch.equal(words, want_words), family
        assert torch.equal(ok, want_ok) and bool(ok.all()), family
        got = icfl_cuda.hash_words(words, args[2], 42)
        assert icfl_cuda.LAUNCHES["hash_words"] == before["hash_words"] + 1
        for g, w in zip(got, icfl_cuda.hash_words_plain(words, args[2], 42)):
            assert torch.equal(g, w), family


def _route_case(case: str):
    """Windows that take the kernel's staged route (shift windows: a block's
    span fits its cap) and its device-memory route (shuffled, overlapping or
    decreasing starts, rows of 129-1023, 300-character chunks), and a view
    of the stream offset by 3 bytes."""
    rng = np.random.default_rng(len(case))
    if case in ("shift", "shuffled", "overlapping", "decreasing", "offset3"):
        texts = _card_texts(rng, 40, 100, 400) + ["AC" * 150, "T" * 299 + "A"]
        flat, starts, lengths, _ = window_stream(texts, shift=True)
        if case == "shuffled":
            order = rng.permutation(len(starts))
            starts, lengths = starts[order], lengths[order]
        elif case == "overlapping":
            starts = np.sort(rng.integers(0, len(flat) - 100, size=len(starts)))
        elif case == "decreasing":
            starts, lengths = starts[::-1].copy(), lengths[::-1].copy()
        return torch.from_numpy(flat), torch.from_numpy(starts), torch.from_numpy(lengths)
    if case == "chunks300":
        return _stream(_card_texts(rng, 2000, 300, 300))
    widths = {"edges128": (127, 128, 129), "edges256": (255, 256, 1023)}[case]
    texts = [t for w in widths for t in _card_texts(rng, 60, w, w)]
    return _stream(texts + ["AC" * (widths[-1] // 2), "T" * (widths[-1] - 1) + "A"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["shift", "shuffled", "overlapping", "decreasing", "offset3",
                                  "chunks300", "edges128", "edges256"])
def test_factor_words_routes_match_plain_on_card(cuda_device, case):
    args = [t.to(cuda_device) for t in _route_case(case)]
    if case == "offset3":
        args[0] = torch.cat([torch.zeros(3, dtype=torch.uint8, device=cuda_device), args[0]])[3:]
        assert args[0].data_ptr() % 16 == 3  # a view that is not 16-byte aligned
    for family in FAMILY_PLANS:
        words, ok = icfl_cuda.factor_words(*args, family)
        want_words, want_ok = icfl_cuda.factor_words_plain(*args, family)
        torch.cuda.synchronize()
        assert torch.equal(ok, want_ok) and bool(ok.all()), (case, family)
        assert torch.equal(words, want_words), (case, family)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["CFL_COMB", "ICFL_COMB", "CFL_ICFL_COMB-10"])
def test_factor_words_flags_rows_on_card(cuda_device, family):
    """Windows outside the stream (through the wrapper) and windows wider
    than 32 W (through the C entry point with W = 2): zero words, ok 0."""
    from fpmash_tpu_torch.ops._build import check, library
    from fpmash_tpu_torch.ops.factorize import plan

    texts = _card_texts(np.random.default_rng(5), 64, 1, 100)
    flat, starts, lengths = (t.to(cuda_device) for t in _stream(texts))
    N = flat.numel()
    bad_starts = torch.cat([starts, torch.tensor([N - 2, -1, N, N - 100], device=cuda_device)])
    bad_lengths = torch.cat([lengths, torch.tensor([3, 5, 1, 100], dtype=torch.int32,
                                                   device=cuda_device)])
    words, ok = icfl_cuda.factor_words(flat, bad_starts, bad_lengths, family)
    want_words, want_ok = icfl_cuda.factor_words_plain(flat, bad_starts, bad_lengths, family)
    assert torch.equal(words, want_words) and torch.equal(ok, want_ok)
    assert ok.tolist()[-4:] == [False, False, False, True]

    base, threshold, comb = plan(family)
    W = 2
    words = torch.full((len(texts), W), -1, dtype=torch.int32, device=cuda_device)
    ok = torch.full((len(texts),), True, device=cuda_device)
    code = library().fpmash_factor_words(
        flat.data_ptr(), N, starts.data_ptr(), lengths.data_ptr(), len(texts),
        {"cfl": 0, "icfl": 1, "cfl_icfl": 2}[base], threshold or 0, int(comb),
        int(lengths.max()), words.data_ptr(), W, ok.data_ptr(),
        torch.cuda.current_stream(cuda_device).cuda_stream)
    check(code, "factor_words kernel launch")
    torch.cuda.synchronize()
    narrow = lengths <= 32 * W
    assert torch.equal(ok, narrow)
    assert not words[~narrow].any()
    want, _ = icfl_cuda.factor_words_plain(flat, starts, lengths, family)
    assert torch.equal(words[narrow], want[narrow][:, :W])


@pytest.mark.gpu
def test_hash_kernel_matches_plain_on_random_words(cuda_device):
    rng = np.random.default_rng(77)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3000, 3)).astype(np.int32))
    lengths = rng.integers(0, 97, size=3000).astype(np.int32)
    lengths[:3] = [-1, 97, 0]
    args = [words.to(cuda_device), torch.from_numpy(lengths).to(cuda_device)]
    for g, w in zip(icfl_cuda.hash_words(*args, 9), icfl_cuda.hash_words_plain(*args, 9)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 4, 5, 8, 32])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset4"])
def test_hash_kernel_matches_plain_at_every_width(cuda_device, W, offset):
    """Rows of 1 to 32 words (windows up to MAX_ICFL_WIDTH), every n from 0
    to 32 W and invalid ones, bits at and past n, odd and even factor
    counts; rows 16-byte aligned and a view 4 bytes in (the 4-byte loads)."""
    from test_torch_hash_words_body import _rows

    words, lengths = _rows(W + 100, 32 * W + 300, W)
    flat = torch.from_numpy(words.view(np.int32).reshape(-1))
    buf = torch.zeros(offset + flat.numel(), dtype=torch.int32, device=cuda_device)
    buf[offset:] = flat.to(cuda_device)
    args = [buf[offset:].view(words.shape), torch.from_numpy(lengths).to(cuda_device)]
    assert args[0].data_ptr() % 16 == 4 * offset
    before = icfl_cuda.LAUNCHES["hash_words"]
    got = icfl_cuda.hash_words(*args, 9)
    assert icfl_cuda.LAUNCHES["hash_words"] == before + 1
    want = icfl_cuda.hash_words_plain(*args, 9)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    count = want[2][want[2] >= 0]
    assert bool((count % 2 == 0).any()) and bool((count % 2 == 1).any())
