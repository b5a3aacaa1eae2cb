"""Bitonic row sort of (key, payload) planes: kernel K15, its plain version, its wrapper.

Counterpart of ``fpmash_tpu/ops/sort_pallas.py`` (Pallas ``_psort_kernel``
behind ``row_sort_planes_pallas``; unrouted in the JAX package, whose
bottom-k compaction stays on ``lax.sort``).  Planes are ``int32 [C, 4096]``
holding u32 bits, ``C`` a multiple of 8 as the JAX function requires; each
row is sorted ascending by key as unsigned and the payload moves with its
key.  Kernel and plain version run the TPU kernel's bitonic network with
its tie rule (swap only on a strict inequality), so the payload order among
equal keys is the JAX kernel's too; ``torch.sort`` and ``lax.sort`` order
ties otherwise.

:func:`row_sort_planes` launches the CUDA kernel (``csrc/row_sort.cu``) for
tensors on a CUDA device and runs :func:`row_sort_planes_plain` for tensors
on the CPU.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0

COLS = 4096
ROWS_MULTIPLE = 8
_SIGN32 = -(1 << 31)


def _check(keys, payload):
    for name, x in (("keys", keys), ("payload", payload)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32, got {x.dtype}")
    if keys.dim() != 2 or keys.shape[1] != COLS or keys.shape[0] % ROWS_MULTIPLE:
        raise ValueError(f"row_sort_planes needs [8k, {COLS}] planes, got {tuple(keys.shape)}")
    if payload.shape != keys.shape or payload.device != keys.device:
        raise ValueError(f"payload {tuple(payload.shape)} on {payload.device} does not match "
                         f"keys {tuple(keys.shape)} on {keys.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_sort_planes runs on cpu or cuda tensors, not {keys.device}")


def row_sort_planes(keys: torch.Tensor, payload: torch.Tensor):
    """``(sorted_keys, moved_payload)``, each ``int32 [C, 4096]``: every row
    ascending by key as unsigned, ties in the bitonic network's order."""
    global LAUNCHES
    _check(keys, payload)
    dev = keys.device
    if dev.type == "cpu":
        return row_sort_planes_plain(keys, payload)
    from fpmash_tpu_torch.ops._build import check, library

    out_keys = torch.empty_like(keys)
    out_payload = torch.empty_like(payload)
    if keys.shape[0] == 0:
        return out_keys, out_payload
    # the kernel moves 16-byte vectors: a view that starts inside a row is copied
    keys, payload = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (keys, payload))
    with torch.cuda.device(dev):
        code = library().fpmash_row_sort(
            keys.data_ptr(), payload.data_ptr(), keys.shape[0], out_keys.data_ptr(),
            out_payload.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "row sort kernel launch")
    LAUNCHES += 1
    return out_keys, out_payload


def row_sort_planes_plain(keys: torch.Tensor, payload: torch.Tensor):
    """Plain version of :func:`row_sort_planes`, on any device: the same
    network, one step at a time over all rows.  At stage ``s`` and distance
    ``d`` element ``i`` meets ``i ^ d``; the pair is ascending iff ``(i & s)
    == 0``; each side takes its partner's pair only where the partner's key
    belongs on its side strictly."""
    _check(keys, payload)
    k = keys ^ _SIGN32  # signed order of the flipped keys is their unsigned order
    v = payload
    lane = torch.arange(COLS, device=keys.device)
    s = 2
    while s <= COLS:
        d = s // 2
        while d >= 1:
            partner = lane ^ d
            kq, vq = k[:, partner], v[:, partner]
            keep_min = ((lane & d) == 0) == ((lane & s) == 0)
            take = torch.where(keep_min, kq < k, kq > k)
            k = torch.where(take, kq, k)
            v = torch.where(take, vq, v)
            d //= 2
        s *= 2
    return k ^ _SIGN32, v
