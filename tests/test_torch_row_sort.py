"""Port: the bitonic row sort K15 (plain version on the CPU) vs the JAX package.

The same planes, made with numpy from a seed, go through the JAX package's
``row_sort_planes_pallas`` in Pallas interpret mode (as tests/test_kmers.py
runs it), through ``lax.sort`` and through
``fpmash_tpu_torch.ops.sort_cuda.row_sort_planes`` on CPU tensors.  Keys
and payloads are integers: every comparison is exact.  The port runs the
TPU kernel's network and tie rule, so its payload order among equal keys
equals the JAX kernel's; ``lax.sort`` orders ties otherwise and is compared
as multisets.

The test marked ``gpu`` holds the kernel against its plain version on a
card; the test functions import JAX only inside the CPU tests, so on a
machine with a card and no JAX it runs with ``python -m pytest
tests/test_torch_row_sort.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from fpmash_tpu_torch.ops import sort_cuda


KEYSETS = ["small", "wide", "equal", "few", "reversed", "high"]
#: key sets whose rows hold equal keys in an order the network does not keep
TIED = {"small", "wide", "few", "high"}


def _planes(rng, rows, keyset):
    """Keys of one of ``KEYSETS``: drawn from 50 values (heavy ties), small
    ones as in tests/test_kmers.py, or spread over the u32 range with the
    high bit and 0xFFFFFFFF; all one value; drawn from 3 values; each row
    strictly decreasing; drawn from 50 values that all have the high bit
    set.  Payloads random u32."""
    shape = (rows, sort_cuda.COLS)
    if keyset == "equal":
        keys = np.full(shape, 0x9E3779B9, np.uint32)
    elif keyset == "reversed":
        start = rng.integers(sort_cuda.COLS, 2**32, size=(rows, 1), dtype=np.uint64)
        keys = (start - np.arange(sort_cuda.COLS, dtype=np.uint64)).astype(np.uint32)
    else:
        n = 3 if keyset == "few" else 50
        if keyset == "small":
            values = np.arange(n, dtype=np.uint32)
        else:
            values = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        if keyset == "wide":
            values[:3] = [0, 2**31, 2**32 - 1]
        if keyset == "high":
            values |= np.uint32(1 << 31)
        keys = values[rng.integers(0, n, size=shape)]
    pay = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return keys, pay


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("keyset", KEYSETS)
def test_row_sort_plain_matches_pallas_and_lax_sort(keyset):
    import jax
    import jax.numpy as jnp

    from fpmash_tpu.ops.sort_pallas import row_sort_planes_pallas

    rng = np.random.default_rng(13 + KEYSETS.index(keyset))
    keys, pay = _planes(rng, 8, keyset)
    got_k, got_p = sort_cuda.row_sort_planes(_torch(keys), _torch(pay))
    got_k = got_k.numpy().view(np.uint32)
    got_p = got_p.numpy().view(np.uint32)
    jk, jp = row_sort_planes_pallas(jnp.asarray(keys), jnp.asarray(pay), interpret=True)
    assert np.array_equal(got_k, np.asarray(jk))
    assert np.array_equal(got_p, np.asarray(jp))  # ties in the network's order

    wk, wp = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pay)), num_keys=1)
    wk, wp = np.asarray(wk), np.asarray(wp)
    assert np.array_equal(got_k, wk)
    assert np.array_equal(got_k, np.sort(keys, axis=1))
    for r in range(len(keys)):
        assert sorted(zip(got_k[r], got_p[r])) == sorted(zip(wk[r], wp[r]))
    stable = all(np.array_equal(got_p[r], pay[r][np.argsort(keys[r], kind="stable")])
                 for r in range(len(keys)))
    # ties do not keep their input order: the payload order is the network's
    # own (rows of one key never swap, rows of distinct keys have no ties)
    assert stable == (keyset not in TIED)


def test_row_sort_checks_and_count():
    rng = np.random.default_rng(3)
    keys, pay = _planes(rng, 16, "small")
    before = sort_cuda.LAUNCHES
    k, p = sort_cuda.row_sort_planes(_torch(keys), _torch(pay))
    assert sort_cuda.LAUNCHES == before  # the plain version is not a launch
    assert np.array_equal(k.numpy().view(np.uint32), np.sort(keys, axis=1))
    with pytest.raises(ValueError, match=r"\[8k, 4096\]"):
        sort_cuda.row_sort_planes(_torch(keys[:12]), _torch(pay[:12]))
    with pytest.raises(ValueError, match=r"\[8k, 4096\]"):
        sort_cuda.row_sort_planes(_torch(keys[:, :2048]), _torch(pay[:, :2048]))
    with pytest.raises(ValueError, match="int32"):
        sort_cuda.row_sort_planes(_torch(keys).long(), _torch(pay))
    with pytest.raises(ValueError, match="does not match"):
        sort_cuda.row_sort_planes(_torch(keys), _torch(pay[:8]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sort_cuda.row_sort_planes(_torch(keys).to("meta"), _torch(pay).to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("keyset", KEYSETS)
def test_row_sort_kernel_matches_plain_on_card(cuda_device, keyset):
    rng = np.random.default_rng(15)
    keys, pay = _planes(rng, 264, keyset)
    args = (_torch(keys).to(cuda_device), _torch(pay).to(cuda_device))
    before = sort_cuda.LAUNCHES
    got = sort_cuda.row_sort_planes(*args)
    assert sort_cuda.LAUNCHES == before + 1
    want = sort_cuda.row_sort_planes_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
