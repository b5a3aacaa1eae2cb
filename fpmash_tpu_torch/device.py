"""Placement: the devices a command runs on, the counted copies, the card report.

The port runs on the devices it is given and nowhere else: asking for
``cuda`` on a machine without a usable card is an error, never a silent
move to the CPU.  The CPU is chosen only by asking for it, and then every
kernel wrapper runs its plain PyTorch version.

:func:`resolve_devices` is the one place where ``--device`` becomes
devices: a non-empty tuple of ``torch.device``.  A route that can shard
takes the tuple as ``devices`` and gathers its results on ``devices[0]``;
a route that cannot takes ``devices[0]`` as ``device``.

:func:`to_device`, :func:`file_to_device` and :func:`to_host` are the
copies across the bus, each counted on the open span (``utils/trace.py``).
"""

from __future__ import annotations

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fpmash_tpu_torch.utils.trace import count

#: :func:`file_to_device`'s pinned buffers: bytes of each, how many take
#: turns, and the threads that read into them
UPLOAD_CHUNK, UPLOAD_STAGES, UPLOAD_READERS = 8 << 20, 8, 4


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


def _pread(fd: int, buf: np.ndarray, offset: int) -> int:
    """Read the file ``fd`` from ``offset`` into ``buf`` until it is full or
    the file ends; the bytes read."""
    view, got = memoryview(buf), 0
    while got < len(view):
        step = os.preadv(fd, [view[got:]], offset + got)
        if not step:
            break
        got += step
    return got


def _first_kept(buf: np.ndarray, skip: np.ndarray) -> int:
    """Index of the first byte of ``buf`` not in ``skip``, or ``len(buf)``."""
    for pos in range(0, len(buf), 4096):
        kept = np.flatnonzero(~np.isin(buf[pos : pos + 4096], skip))
        if kept.size:
            return pos + int(kept[0])
    return len(buf)


def file_to_device(path: str, dev, lstrip: bytes) -> torch.Tensor:
    """The bytes of the file ``path`` after its leading run of bytes in
    ``lstrip``, as a ``uint8`` tensor on ``dev``; they count as
    ``h2d_bytes`` of the open span (see :func:`to_device`).

    To a card the file goes in chunks of ``UPLOAD_CHUNK`` bytes, read by
    ``UPLOAD_READERS`` threads (``os.preadv`` lets go of the GIL) into
    ``UPLOAD_STAGES`` pinned buffers in turn (PyTorch's caching host
    allocator keeps them across calls) and copied in order, without
    blocking, into one device buffer; a buffer is read into again once the
    event after its copy has passed, so the copies overlap the reads.  On
    the CPU the file is read straight into the tensor."""
    dev = torch.device(dev)
    skip = np.frombuffer(lstrip, np.uint8)
    size = os.path.getsize(path)
    out = torch.empty(size, dtype=torch.uint8, device=dev)
    fd = os.open(path, os.O_RDONLY)
    try:
        if dev.type == "cpu":
            host = out.numpy()
            got = _pread(fd, host, 0)
            lead = _first_kept(host[:got], skip)
            count("h2d_bytes", got - lead)
            return out[lead:got]
        filled = _upload(fd, size, out, skip)
    finally:
        os.close(fd)
    count("h2d_bytes", filled)
    return out[:filled]


def _upload(fd: int, size: int, out: torch.Tensor, skip: np.ndarray) -> int:
    """:func:`file_to_device`'s chunked copy of the file ``fd`` of ``size``
    bytes into the card tensor ``out``; the bytes copied."""
    chunks = -(-size // UPLOAD_CHUNK)
    stages = [torch.empty(UPLOAD_CHUNK, dtype=torch.uint8, pin_memory=True)
              for _ in range(min(UPLOAD_STAGES, chunks))]
    filled, kept = 0, not skip.size

    def read(after: torch.cuda.Event | None, i: int) -> int:
        if after is not None:
            after.synchronize()
        at = i * UPLOAD_CHUNK
        return _pread(fd, stages[i % len(stages)].numpy()[: min(UPLOAD_CHUNK, size - at)], at)

    with torch.cuda.device(out.device), ThreadPoolExecutor(UPLOAD_READERS) as pool:
        stream = torch.cuda.current_stream(out.device)
        reads = {i: pool.submit(read, None, i) for i in range(len(stages))}
        for i in range(chunks):
            got = reads.pop(i).result()
            host = stages[i % len(stages)]
            lead = 0 if kept else _first_kept(host.numpy()[:got], skip)
            kept = kept or lead < got
            if lead < got:
                out[filled : filled + got - lead].copy_(host[lead:got], non_blocking=True)
                filled += got - lead
            copied = torch.cuda.Event()
            copied.record(stream)
            if i + len(stages) < chunks:
                reads[i + len(stages)] = pool.submit(read, copied, i + len(stages))
    return filled


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
