"""Device selection and the card report.

The port runs on the device it is given and nowhere else: asking for
``cuda`` on a machine without a usable card is an error, never a silent
move to the CPU.  The CPU is chosen only by asking for it, and then every
kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``; raises if it names an absent card."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} was asked for, but torch.cuda.is_available() "
                "is False (no usable CUDA card or no CUDA build of PyTorch); "
                "pass --device cpu to run the plain PyTorch versions"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(name)!r} was asked for, but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {str(name)!r}: use cuda or cpu")
    return dev


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
