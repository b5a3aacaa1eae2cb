"""Placement: the devices a command runs on, the counted copies, the card report.

The port runs on the devices it is given and nowhere else: asking for
``cuda`` on a machine without a usable card is an error, never a silent
move to the CPU.  The CPU is chosen only by asking for it, and then every
kernel wrapper runs its plain PyTorch version.

:func:`resolve_devices` is the one place where ``--device`` becomes
devices: a non-empty tuple of ``torch.device``.  A route that can shard
takes the tuple as ``devices`` and gathers its results on ``devices[0]``;
a route that cannot takes ``devices[0]`` as ``device``.

:func:`to_device` and :func:`to_host` are the copies across the bus, each
counted on the open span (``utils/trace.py``).
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from fpmash_tpu_torch.utils.trace import count


def resolve_devices(name: str | torch.device) -> tuple[torch.device, ...]:
    """The devices for ``--device name``: for ``cuda`` every visible card,
    capped by ``FPMASH_DEVICES=N`` (the JAX package's knob,
    ``fpmash_tpu/parallel/sharded.py:38-52``); for ``cuda:N`` that card
    alone; for ``cpu`` the CPU.  Raises if ``name`` names an absent card."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return (dev,)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {str(name)!r}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} was asked for, but torch.cuda.is_available() "
            "is False (no usable CUDA card or no CUDA build of PyTorch); "
            "pass --device cpu to run the plain PyTorch versions"
        )
    cards = torch.cuda.device_count()
    if dev.index is not None:
        if dev.index >= cards:
            raise RuntimeError(
                f"device {str(name)!r} was asked for, but only {cards} CUDA device(s) are visible"
            )
        return (dev,)
    cap = os.environ.get("FPMASH_DEVICES", "").strip()
    n = min(cards, int(cap)) if cap else cards
    return tuple(torch.device("cuda", i) for i in range(max(1, n)))


def to_device(a, dev) -> torch.Tensor:
    """``a`` (a tensor, or a numpy array) as a contiguous tensor on ``dev``.

    Where ``a`` lies on the host, its bytes count as ``h2d_bytes`` of the
    open span, whatever ``dev`` is: the count is what the route hands
    across, so a CPU run counts what a card would get."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    a = a.contiguous()
    if a.device.type == "cpu":
        count("h2d_bytes", a.nbytes)
    return a.to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host; its bytes count as ``d2h_bytes``
    of the open span, whatever device it is on (see :func:`to_device`)."""
    count("d2h_bytes", t.nbytes)
    return t.cpu().numpy()


def gpu_report() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints them.

    Every time taken on a card is reported beside this line: a card set
    below its maximum power limit runs slower under load.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]
