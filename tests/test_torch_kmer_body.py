"""Port: a numpy model of the k-mer hash body of ``csrc/kmer_hash.cu`` vs the plain versions.

The CUDA kernels K5-K8 and K10-K12 run only on a card.  This file keeps
their arithmetic testable here: a numpy model that follows the kernel's
steps one by one -- the byte map, the staging of a tile and its halo into
packed little-endian codes and invalid flags, the O(1) window read by funnel
shifts, ``R = le ^ M`` and ``F`` by bit reversal, the pick, the bytes of the
pick spread from its digits by shift-masks and byte permutes with a zero
selector at ``k`` and above, and MurmurHash3 over those words -- is held
exactly against ``ops/kmers_cuda.py``'s plain versions, which the JAX package
checks (``tests/test_torch_kmers.py``, ``tests/test_torch_kmer_variants.py``).
Invalid codes sit on tile edges and at the stream's end; lengths fall on tile
multiples and one off them.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import kmers, kmers_cuda
from fpmash_tpu_torch.ops.murmur3 import _block_update, _finalize, _mix_k1, _mix_k2, to_signed

TILE = 4096  # csrc/kmer_hash.cu kTile: positions a block hashes
BLOCK = kmers_cuda.BLOCK  # K10's block
M32 = np.uint64(0xFFFFFFFF)
_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _u(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


# ---------------------------------------------------------------------- #
# the device intrinsics, on uint64 arrays
# ---------------------------------------------------------------------- #


def _funnel_r(a, b, s):
    """``__funnelshift_r(a, b, s)``: the low 32 bits of ``(b:a) >> (s & 31)``."""
    return (((_u(b) << np.uint64(32)) | _u(a)) >> (_u(s) & np.uint64(31))) & M32


def _brev64(x):
    """``__brevll``: the 64 bits in reverse order."""
    x = np.ascontiguousarray(_u(x))
    return _REV8[x.view(np.uint8)].view(np.uint64).byteswap()


def _byte_perm(x, y, s):
    """``__byte_perm(x, y, s)``: byte n is byte ``(s >> 4n) & 7`` of ``y:x``."""
    x, y, s = _u(x), _u(y), _u(s)
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(7)
        src = np.where(sel < 4, x, y)
        byte = (src >> (np.uint64(8) * (sel & np.uint64(3)))) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * n)
    return out


def _swap_pairs(x):
    m = np.uint64(0x5555555555555555)
    return ((x >> np.uint64(1)) & m) | ((x & m) << np.uint64(1))


# ---------------------------------------------------------------------- #
# the body, step by step
# ---------------------------------------------------------------------- #


def _byte_code(b, preserve_case):
    """``ByteStream::code``: fold with ``& 0xDF``, code from bits 1-2, then
    valid iff the byte is that code's letter; any other byte is 4."""
    u = _u(b) & np.uint64(0xFF if preserve_case else 0xDF)
    c = ((u >> np.uint64(1)) & np.uint64(3)) ^ ((u >> np.uint64(2)) & np.uint64(1))
    return np.where(u == _byte_perm(0x54474341, 0, np.uint64(0x4440) | c), c, np.uint64(4))


class Shape:
    """``KmerShape``: what every window of a launch shares, from k."""

    def __init__(self, k):
        self.k = k
        self.flip = 64 - 2 * k
        self.digits = np.uint64(0xFFFFFFFFFFFFFFFF >> (64 - 2 * k))
        self.codes = np.uint64(0xFFFFFFFF >> (32 - k))
        self.pad = []
        for i in range(4):
            r = k - 8 * i
            self.pad.append(0 if r >= 8 else 0x44444444 if r <= 0
                            else (0x44444444 << (4 * r)) & 0xFFFFFFFF)


def _stage(code_at, base, chunks):
    """``stage``: packed[c] holds the codes of chunk c (position ``base + q``
    at bits ``2 (q & 15)`` of word ``q >> 4``, as ``code & 3``), bad[w] the
    invalid flags (bit ``q & 31`` of word ``q >> 5``)."""
    q = np.arange(16 * chunks)
    code = _u(code_at(base + q))
    bits = (code & np.uint64(3)) << _u(2 * (q % 16))
    flags = (code > 3).astype(np.uint64) << _u(q % 32)
    return bits.reshape(chunks, 16).sum(axis=1), flags.reshape(chunks // 2, 32).sum(axis=1)


def _staged_window(packed, bad, q, s, wide):
    """``staged_window``: ``le`` (the code of position q + j at bits 2j) and
    whether the window's k codes are valid."""
    w, shift = q >> 4, 2 * (q & 15)
    le = _funnel_r(packed[w], packed[w + 1], shift)
    if wide:
        le |= _funnel_r(packed[w + 1], packed[w + 2], shift) << np.uint64(32)
    v = q >> 5
    ok = (_funnel_r(bad[v], bad[v + 1], q & 31) & s.codes) == 0
    return le & s.digits, ok


def _ascii_word(x, pad):
    """``ascii_word``: 8 digits (bytes 0 and 2 of x) to 8 ASCII bytes, a
    selector nibble of 4 or more giving a zero byte."""
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    x = ((x | (x << np.uint64(2))) & np.uint64(0x33333333)) | np.uint64(pad)
    lo = _byte_perm(0x54474341, 0, x)
    hi = _byte_perm(0x54474341, 0, x >> np.uint64(16))
    return (hi << np.uint64(32)) | lo


def _digit_words(L, s):
    """The four little-endian words of the message: byte j the ASCII of the
    digit at bits 2j of L, 0 at j >= k."""
    lo, hi = L & M32, L >> np.uint64(32)
    return [_ascii_word(_byte_perm(lo, 0, 0x4140), s.pad[0]),
            _ascii_word(_byte_perm(lo, 0, 0x4342), s.pad[1]),
            _ascii_word(_byte_perm(hi, 0, 0x4140), s.pad[2]),
            _ascii_word(_byte_perm(hi, 0, 0x4342), s.pad[3])]


def _digits_hash(L, s, seed=42):
    """``digits_hash``: MurmurHash3_x64_128's h1 over the k bytes."""
    w = [torch.from_numpy(np.ascontiguousarray(x).view(np.int64)) for x in _digit_words(L, s)]
    h1 = torch.full_like(w[0], to_signed(seed))
    h2 = h1.clone()
    nblocks, tail = divmod(s.k, 16)
    for b in range(nblocks):
        h1, h2 = _block_update(h1, h2, w[2 * b], w[2 * b + 1])
    if tail > 8:
        h2 = h2 ^ _mix_k2(w[2 * nblocks + 1])
    if tail > 0:
        h1 = h1 ^ _mix_k1(w[2 * nblocks])
    return _finalize(h1, h2, s.k)[0].numpy().view(np.uint64)


def _forward(le, s, wide):
    """F, the big-endian window, from le: bit reversal, pair swap, shift
    (the 32-bit instance of k <= 16 reverses 32 bits)."""
    if wide:
        return _swap_pairs(_brev64(le)) >> np.uint64(s.flip)
    rev32 = _brev64(le) >> np.uint64(32)
    return _swap_pairs(rev32) >> np.uint64(s.flip - 32)


def _window_hash(le, s, noncanonical, wide, seed=42):
    """``window_hash``: R = le ^ M, F reversed; R only when R < F; the
    pick's little-endian digits are le (F) or F ^ M (R)."""
    F = _forward(le, s, wide)
    take_r = np.zeros(le.shape, bool) if noncanonical else (le ^ s.digits) < F
    return _digits_hash(np.where(take_r, F ^ s.digits, le), s, seed)


def _model_windows(code_at, n, k, tile):
    """``(le, ok)`` of every position < n, staged tile by tile."""
    s, wide = Shape(k), k > 16
    les, oks = [], []
    for base in range(0, n, tile):
        packed, bad = _stage(code_at, base, tile // 16 + 2)
        q = np.arange(min(tile, n - base))
        le, ok = _staged_window(packed, bad, q, s, wide)
        les.append(le)
        oks.append(ok)
    return np.concatenate(les), np.concatenate(oks)


def _model_planes(code_at, n, k, noncanonical, tile=TILE):
    le, ok = _model_windows(code_at, n, k, tile)
    h = _window_hash(le, Shape(k), noncanonical, k > 16)
    return h, ok


def _byte_stream(seq, preserve_case):
    codes = _byte_code(seq, preserve_case)
    return lambda q: np.where(q < len(seq), codes[np.minimum(q, len(seq) - 1)], np.uint64(4))


def _planes_u64(lo, hi):
    return ((hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.numpy().view(np.uint32).astype(np.uint64))


def _edge_bytes(rng, n, invalid_rate=0.01):
    """ACGT with lowercase stretches, N, IUPAC codes and NUL sprinkled in,
    and invalid bytes on the tile edges and the stream's last position."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()
    for start in rng.integers(0, n, size=max(1, n // 400)):
        seq[start : start + int(rng.integers(5, 60))] += 32
    bad = rng.random(n) < invalid_rate
    seq[bad] = np.frombuffer(b"NRYKM\x00n", np.uint8)[rng.integers(0, 7, size=int(bad.sum()))]
    for edge in range(TILE, n + 1, TILE):
        for d in (-1, 0, 31):
            if 0 <= edge + d < n:
                seq[edge + d] = ord("N")
    seq[-1] = ord("n")
    return seq


# ---------------------------------------------------------------------- #
# tests
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("preserve_case", [False, True])
def test_byte_code_equals_the_plain_map(preserve_case):
    """All 256 bytes: the kernel's map (``& 0xDF``, bits 1-2, letter check)
    is the plain versions' fold and table."""
    b = np.arange(256)
    want = kmers._CODES[kmers._fold_case(torch.from_numpy(b.astype(np.uint8)),
                                         preserve_case).long().numpy()]
    assert np.array_equal(_byte_code(b, preserve_case), want.astype(np.uint64))


@pytest.mark.parametrize("k", [1, 8, 9, 15, 16, 17, 21, 24, 31, 32])
def test_window_identities_and_bytes(k):
    """On one tile and its halo: le is the packed window, ``le ^ M`` the
    plain versions' R, the reversal their F, and the message words carry the
    ASCII of the pick's digits with zero bytes at k and above."""
    rng = np.random.default_rng(900 + k)
    seq = _edge_bytes(rng, TILE + 100)
    n = len(seq)
    le, ok = _model_windows(_byte_stream(seq, False), n, k, TILE)
    codes = torch.from_numpy(kmers._CODES[kmers._fold_case(torch.from_numpy(seq), False).long()])
    F, R, valid = kmers._pack_windows(torch.nn.functional.pad(codes, (0, k - 1), value=4), n, k)
    s = Shape(k)
    assert np.array_equal(ok, valid.numpy())
    assert np.array_equal(le ^ s.digits, R.numpy().view(np.uint64))
    assert np.array_equal(_forward(le, s, k > 16), F.numpy().view(np.uint64))

    L = rng.integers(0, 2**64, size=500, dtype=np.uint64) & s.digits
    words = np.stack(_digit_words(L, s), axis=1).view(np.uint8).reshape(500, 32)
    digits = (L[:, None] >> (2 * np.arange(32, dtype=np.uint64))) & np.uint64(3)
    want = np.frombuffer(b"ACGT", np.uint8)[digits.astype(np.int64)]
    want[:, k:] = 0
    assert np.array_equal(words, want)


@pytest.mark.parametrize("k", [1, 8, 9, 15, 16, 17, 21, 24, 31, 32])
@pytest.mark.parametrize("noncanonical", [False, True])
def test_model_equals_plain_planes(k, noncanonical):
    """K7/K8: every position's hash and validity, case folded and kept, at
    lengths on a tile multiple and one off it."""
    rng = np.random.default_rng(1000 + k)
    for preserve_case, n in ((False, 2 * TILE + (k % 3) - 1), (True, TILE)):
        seq = _edge_bytes(rng, n)
        h, ok = _model_planes(_byte_stream(seq, preserve_case), n, k, noncanonical)
        lo, hi, valid = kmers_cuda.kmer_hashes_planes_plain(
            torch.from_numpy(seq), k=k, noncanonical=noncanonical, preserve_case=preserve_case)
        assert np.array_equal(ok, valid.numpy())
        assert np.array_equal(h, _planes_u64(lo, hi))


@pytest.mark.parametrize("k,noncanonical", [(17, False), (21, False), (32, True)])
def test_model_equals_plain_topk8(k, noncanonical):
    """K5: the model's survivors in groups of 128, the 8 smallest ascending,
    padded, and the overflow flag, at a sparse and a dense threshold."""
    rng = np.random.default_rng(1100 + k)
    n = 2 * TILE + 1
    seq = _edge_bytes(rng, n)
    h, ok = _model_planes(_byte_stream(seq, False), n, k, noncanonical)
    pad = np.uint64(2**64 - 1)
    for t_hi, length in ((0x01000000, n), (0x30000000, n - 500)):
        p = np.arange(n)
        keep = ok & (p <= length - k) & ((h >> np.uint64(32)) <= t_hi) & (h != pad)
        groups = np.full(-(-n // 128) * 128, pad)
        groups[:n] = np.where(keep, h, pad)
        groups = groups.reshape(-1, 128)
        want = np.sort(groups, axis=1)[:, :8].reshape(-1)
        clo, chi, overflow = kmers_cuda.kmer_hashes_topk8_planes_plain(
            torch.from_numpy(seq), t_hi, length, k=k, noncanonical=noncanonical)
        assert np.array_equal(_planes_u64(clo, chi), want)
        assert bool(overflow) == bool(((groups != pad).sum(axis=1) > 8).any())
        assert (want != pad).sum() > 8


@pytest.mark.parametrize("k", [1, 16, 17, 21, 32])
def test_model_equals_plain_wrapped_codes(k):
    """K12: int32 codes of 4-7 (packing as ``code & 3``, so 7 as 3) and
    beyond, on tile edges and at the end, through the wrapped stream: at
    ``N = Np`` the last windows read the stream's head."""
    rng = np.random.default_rng(1200 + k)
    for n in (BLOCK, BLOCK + TILE + 1):
        codes = rng.integers(0, 4, size=n).astype(np.uint32)
        bad = rng.random(n) < 0.01
        codes[bad] = rng.choice(np.array([4, 5, 6, 7, 255, 2**31, 2**32 - 1], np.uint32),
                                size=int(bad.sum()))
        codes[TILE - 1 : TILE + 1] = (5, 7)
        codes[-1] = 6
        npad = -(-n // BLOCK) * BLOCK

        def code_at(q, codes=codes, n=n, npad=npad):
            q = np.where(q >= npad, q - npad, q)
            return np.where(q < n, codes[np.minimum(q, n - 1)], 4)

        h, ok = _model_planes(code_at, n, k, False)
        lo, hi, valid = kmers_cuda.kmer_hashes_fused_planes_plain(
            torch.from_numpy(codes.view(np.int32)), k=k)
        assert np.array_equal(ok, valid.numpy())
        assert np.array_equal(h, _planes_u64(lo, hi))


@pytest.mark.parametrize("k", [1, 8, 16, 21, 25, 32])
def test_model_canonical_hash_equals_plain(k):
    """K11: the pick of full 64-bit F and R, reversed to little-endian
    digits (bits above 2k fall off), hashed by the same words."""
    rng = np.random.default_rng(1300 + k)
    F = rng.integers(0, 2**64, size=2000, dtype=np.uint64)
    R = rng.integers(0, 2**64, size=2000, dtype=np.uint64)
    R[:100] = F[:100]
    low = np.uint64((1 << (2 * k)) - 1)
    R[100:200] = (F[100:200] & low) | (R[100:200] & ~low)
    s = Shape(k)
    for noncanonical in (False, True):
        P = F if noncanonical else np.where(R < F, R, F)
        got = _digits_hash(_swap_pairs(_brev64(P)) >> np.uint64(s.flip), s)
        want = kmers_cuda.canonical_murmur_plain(torch.from_numpy(F.view(np.int64)),
                                                 torch.from_numpy(R.view(np.int64)), k=k,
                                                 noncanonical=noncanonical)
        assert np.array_equal(got, want.numpy().view(np.uint64))


def test_model_k10_block_staging():
    """K10's block of 16 384 positions staged with its halo from the code
    stream (positions past N are 4): the masked hashes gathered into the TPU
    groups equal its plain version slot for slot."""
    rng = np.random.default_rng(14)
    n, k = BLOCK + 3000, 21
    codes = rng.integers(0, 4, size=n).astype(np.uint32)
    codes[rng.random(n) < 0.01] = 7
    codes[BLOCK - 1] = 5
    npad = 2 * BLOCK
    h, ok = _model_planes(lambda q: np.where(q < n, codes[np.minimum(q, n - 1)], 4), npad, k,
                          False, tile=BLOCK)
    t_hi, length = 0x40000000, n - 5
    pad = np.uint64(2**64 - 1)
    p = np.arange(npad)
    keep = ok & (p <= length - k) & ((h >> np.uint64(32)) <= t_hi) & (h != pad)
    groups = (np.where(keep, h, pad).reshape(2, 8, 16, 128).transpose(0, 3, 1, 2)
              .reshape(2, 128, 128))
    want = np.sort(groups, axis=2)[:, :, :8].transpose(0, 2, 1).reshape(-1)
    clo, chi, overflow = kmers_cuda.kmer_hashes_packed_topk_planes_plain(
        torch.from_numpy(codes.view(np.int32)), t_hi, length, k=k)
    assert np.array_equal(_planes_u64(clo, chi), want)
    assert bool(overflow) == bool(((groups != pad).sum(axis=2) > 8).any())
