"""Port: a numpy model of the steps of ``csrc/hash_words.cu`` (K4) vs the plain version.

The CUDA kernel runs only on a card.  This file keeps its steps testable
here: a model that follows the kernel one step at a time -- a row's start
words four at a time in registers (one 16-byte load where the rows are
16-byte aligned and W is a multiple of 4, else a 4-byte load for each word
below n), bits at or past n and bit 0 cleared as they arrive, factor starts
popped from the current word two at a time into one murmur block update --
is held
exactly against ``ops/icfl_cuda.hash_words_plain``, the scalar MurmurHash3
of the factor lengths and the JAX package's Pallas hash kernel in interpret
mode, and checks that no factor but the last takes the one-value update.
JAX is imported inside the test that uses it only.
"""

from __future__ import annotations

import struct
from collections import Counter

import numpy as np
import pytest
import torch
from test_torch_fingerprint_body import M32, Murmur64, ffs

from fpmash_tpu_torch.ops import icfl_cuda
from fpmash_tpu_torch.scalar.murmur3 import murmur3_x64_128


class StartBits:
    """``StartBits<kVec>``: the unpopped bits of word ``k`` in ``cur``, words
    ``k + 1 .. k + 3`` of its group in ``g``."""

    def __init__(self, row, n: int, vec: bool, addr: int, stats: Counter):
        self.row, self.n, self.vec, self.addr, self.stats = row, n, vec, addr, stats
        self.k = 0
        self.load()
        self.cur &= ~1 & M32  # position 0 starts the first factor

    def keep(self, x: int, w: int) -> int:
        left = self.n - 32 * x
        return w if left >= 32 else w & ((1 << left) - 1) if left > 0 else 0

    def load(self) -> None:
        k = self.k
        assert k % 4 == 0
        if self.vec:
            assert (self.addr + 4 * k) % 16 == 0 and k + 4 <= len(self.row)
            self.stats["vector_loads"] += 1
            words = [int(self.row[k + x]) for x in range(4)]
        else:
            used = (self.n + 31) >> 5
            words = [int(self.row[k + x]) if k + x < used else 0 for x in range(4)]
            self.stats["scalar_loads"] += sum(k + x < used for x in range(4))
        self.cur, *self.g = [self.keep(k + x, w) for x, w in enumerate(words)]

    def pop(self) -> int:
        while self.cur == 0:
            if 32 * (self.k + 1) >= self.n:
                return self.n
            self.k += 1
            if self.k % 4 == 0:
                self.load()
            else:
                self.cur = self.g[self.k % 4 - 1]
        p = 32 * self.k + ffs(self.cur) - 1
        self.cur &= (self.cur - 1) & M32
        return p


def hash_words_model(words, lengths, seed: int = 42, addr: int = 0):
    """The kernel's ``(h1, h2, count)`` for ``uint32 words [B, W]`` at byte
    address ``addr`` and ``int32 lengths [B]``, and a Counter of its loads
    and hash updates."""
    words = np.asarray(words, np.uint32)
    B, W = words.shape
    vec = W % 4 == 0 and addr % 16 == 0
    h1, h2 = np.zeros(B, np.uint64), np.zeros(B, np.uint64)
    count = np.full(B, -1, np.int32)
    stats = Counter(vec=vec)
    for b in range(B):
        n = int(lengths[b])
        if n < 0 or n > 32 * W:
            continue
        hash_ = Murmur64(seed)
        starts = StartBits(words[b], n, vec, addr + 4 * W * b, stats)
        pos = 0
        while pos < n:
            a = starts.pop()
            if a >= n:
                hash_.add(n - pos)
                stats["single_updates"] += 1
                break
            c = starts.pop()
            hash_.add_pair(a - pos, c - a)
            stats["pair_updates"] += 1
            pos = c
        hash_.finish()
        h1[b], h2[b], count[b] = hash_.h1, hash_.h2, hash_.count
    return h1.view(np.int64), h2.view(np.int64), count, stats


def _rows(seed: int, B: int, W: int, density: float = 0.25):
    """Random start words (bits past n set too) and lengths: every n from 0
    to 32 W, and invalid ones."""
    rng = np.random.default_rng(seed)
    bits = rng.random((B, 32 * W)) < density
    words = np.packbits(bits.reshape(B, W, 4, 8)[..., ::-1], axis=-1).reshape(B, W, 4)
    words = words.view("<u4").reshape(B, W)
    lengths = rng.integers(0, 32 * W + 1, size=B).astype(np.int32)
    lengths[: 32 * W + 1] = np.arange(min(B, 32 * W + 1))
    lengths[-4:] = [-1, 32 * W + 1, -(2**31), 2**31 - 1]
    return words, lengths


def _plain(words, lengths, seed=42):
    got = icfl_cuda.hash_words_plain(torch.from_numpy(words.view(np.int32).copy()),
                                     torch.from_numpy(lengths), seed)
    return tuple(g.numpy() for g in got)


@pytest.mark.parametrize("W", [1, 3, 4, 5, 8, 32])
@pytest.mark.parametrize("addr", [0, 4])
def test_model_matches_plain(W, addr):
    words, lengths = _rows(W, 32 * W + 40, W)
    h1, h2, count, stats = hash_words_model(words, lengths, 9, addr)
    for got, want, what in zip((h1, h2, count), _plain(words, lengths, 9), ("h1", "h2", "count")):
        bad = np.flatnonzero(got != want)
        assert not len(bad), f"{what}: rows {bad[:8]} differ from the plain version"
    assert stats["vec"] == (W % 4 == 0 and addr == 0)
    assert stats["vector_loads" if stats["vec"] else "scalar_loads"] > 0
    # odd and even factor counts both occur; only the odd ones end on one value
    valid = count >= 0
    assert stats["single_updates"] == int((count[valid] % 2 == 1).sum()) > 0
    assert int((count[valid] % 2 == 0).sum()) > 0


@pytest.mark.parametrize("seed", [42, 0, (1 << 64) - 1])
def test_model_equals_scalar_murmur_of_the_lengths(seed):
    words, lengths = _rows(3, 120, 4, density=0.5)
    h1, h2, count, _ = hash_words_model(words, lengths, seed)
    for b in range(len(lengths)):
        n = int(lengths[b])
        if not 0 <= n <= 128:
            assert count[b] == -1 and h1[b] == 0 and h2[b] == 0
            continue
        bits = [(int(words[b, p >> 5]) >> (p & 31)) & 1 for p in range(n)]
        cuts = [0] + [p for p in range(1, n) if bits[p]] + [n] if n else [0]
        vec = [y - x for x, y in zip(cuts, cuts[1:])]
        want = murmur3_x64_128(b"".join(struct.pack("<Q", v) for v in vec), seed)
        assert (int(h1[b]) & ((1 << 64) - 1), int(h2[b]) & ((1 << 64) - 1)) == want
        assert count[b] == len(vec)


def test_model_matches_pallas_interpret():
    import jax.numpy as jnp

    from fpmash_tpu.ops.icfl_pallas import hash_from_words_fused

    words, lengths = _rows(11, 80, 4)
    lengths = np.clip(lengths, 0, 128)
    # as factor_words writes them: bit 0 set in a non-empty row, none at or past n
    pos = np.arange(128)
    below = (pos[None, :] < lengths[:, None]).reshape(-1, 4, 32)
    words &= (below * (np.uint32(1) << pos[:32].astype(np.uint32))).sum(-1).astype(np.uint32)
    words[:, 0] |= (lengths > 0).astype(np.uint32)
    jh1, jh2, jcnt = hash_from_words_fused(jnp.asarray(words), jnp.asarray(lengths), seed=42,
                                           interpret=True)
    h1, h2, count, _ = hash_words_model(words, lengths)
    assert np.array_equal(h1.view(np.uint64), np.asarray(jh1))
    assert np.array_equal(h2.view(np.uint64), np.asarray(jh2))
    assert np.array_equal(count, np.asarray(jcnt))
