"""Port: batched MurmurHash3 and the int64 convention vs the JAX package.

The same u64 vectors, made with numpy from a seed, go through
``fpmash_tpu.ops.murmur3.murmur3_u64_batch`` (XLA), the scalar model and
``fpmash_tpu_torch.ops.murmur3.murmur3_u64_batch``.  Hashes are integers, so
every comparison is exact.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpmash_tpu.ops.murmur3 import murmur3_u64_batch as jax_murmur3_u64_batch
from fpmash_tpu.scalar.murmur3 import hash_u64_vector, murmur3_x64_128
from fpmash_tpu_torch.ops import murmur3 as port
from fpmash_tpu_torch.scalar import murmur3 as port_scalar


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _vectors(seed: int, B: int, L: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**64, size=(B, L), dtype=np.uint64)  # incl. >= 2^63
    vals[:, ::2] = rng.integers(0, 120, size=vals[:, ::2].shape)  # factor-length-like
    counts = rng.integers(0, L + 1, size=B)
    counts[0] = 0  # the empty vector
    counts[-1] = L
    return vals, counts


@pytest.mark.parametrize("hash_seed", [42, 7])
@pytest.mark.parametrize("seed,B,L", [(0, 32, 7), (1, 17, 16), (2, 9, 1)])
def test_murmur3_u64_batch_matches_jax_and_scalar(seed, B, L, hash_seed):
    vals, counts = _vectors(seed, B, L)
    h1, h2 = port.murmur3_u64_batch(
        torch.from_numpy(vals.view(np.int64)), torch.from_numpy(counts), hash_seed
    )
    jh1, jh2 = jax_murmur3_u64_batch(
        jnp.asarray(vals), jnp.asarray(counts.astype(np.int32)), seed=hash_seed
    )
    assert np.array_equal(_u64(h1), np.asarray(jh1))
    assert np.array_equal(_u64(h2), np.asarray(jh2))
    for b in range(B):
        data = b"".join(struct.pack("<Q", int(v)) for v in vals[b, : counts[b]])
        assert (int(_u64(h1)[b]), int(_u64(h2)[b])) == murmur3_x64_128(data, hash_seed), b


def test_murmur3_u64_batch_empty_shapes():
    """No rows, and rows of width 0: the hash of the empty vector."""
    h1, h2 = port.murmur3_u64_batch(
        torch.zeros((0, 3), dtype=torch.int64), torch.zeros(0, dtype=torch.int64)
    )
    assert h1.shape == h2.shape == (0,)
    h1, h2 = port.murmur3_u64_batch(
        torch.zeros((3, 0), dtype=torch.int64), torch.zeros(3, dtype=torch.int64)
    )
    assert list(map(int, _u64(h1))) == [murmur3_x64_128(b"", 42)[0]] * 3
    assert list(map(int, _u64(h2))) == [murmur3_x64_128(b"", 42)[1]] * 3


@pytest.mark.parametrize("r", [1, 27, 31, 33, 63])
def test_int64_convention_matches_uint64(r):
    rng = np.random.default_rng(r)
    a = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    b = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    b[:64] = a[:64]  # equal pairs
    ta, tb = torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))
    assert np.array_equal(_u64(port.shr(ta, r)), a >> np.uint64(r))
    rot = (a << np.uint64(r)) | (a >> np.uint64(64 - r))
    assert np.array_equal(_u64(port.rotl(ta, r)), rot)
    assert np.array_equal(port.ult(ta, tb).numpy(), a < b)
    assert np.array_equal(_u64(ta * tb + ta), a * b + a)  # wrapping arithmetic
    assert port.to_signed(0xFFFFFFFFFFFFFFFF) == -1
    assert port.to_signed(42) == 42


def test_scalar_copy_matches_jax_scalar():
    rng = np.random.default_rng(5)
    for n in (0, 1, 8, 15, 16, 17, 40):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert port_scalar.murmur3_x64_128(data, 42) == murmur3_x64_128(data, 42)
        vec = [int(v) for v in rng.integers(0, 2**63, size=n % 9)]
        assert port_scalar.hash_u64_vector(vec) == hash_u64_vector(vec)
