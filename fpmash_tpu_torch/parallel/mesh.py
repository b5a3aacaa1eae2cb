"""Mesh helpers: the devices that the shards of a sharded route run on.

Counterpart of :mod:`fpmash_tpu.parallel.mesh`.  A mesh is an ordered tuple
of ``torch.device``: shard ``i`` runs on ``mesh[i]``.  A device may appear
more than once (several shards on one card, or on the CPU); results do not
depend on where a shard runs.
"""

from __future__ import annotations

import torch


def default_mesh(n_devices: int | None = None, device="cuda") -> tuple[torch.device, ...]:
    """A mesh over the first ``n_devices`` cards (all of them by default;
    at most as many as are visible) for ``device`` of type ``cuda``, or
    ``n_devices`` shards on ``device`` itself for any other (one by default).

    The workload is data-parallel at the read, window and pair level, so a
    1-D mesh whose shards are merged by copies to the first device is the
    whole layout (the JAX package's ``dp`` axis).
    """
    dev = torch.device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got n_devices={n_devices}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else min(n_devices, count)
        if n < 1:
            raise RuntimeError("no CUDA card is visible for a cuda mesh")
        return tuple(torch.device("cuda", i) for i in range(n))
    return (dev,) * (n_devices or 1)
