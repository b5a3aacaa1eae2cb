"""Lightweight stage tracing (copy of :mod:`fpmash_tpu.utils.trace`).

Enable with ``FPMASH_TRACE=1``: every traced stage prints
``[fpmash] <stage>: <seconds>s  <extra>`` to stderr.  Zero overhead when
disabled.  Host clock only: a stage that launches device work is timed up
to the point where its results reach the host.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_ENABLED = bool(os.environ.get("FPMASH_TRACE"))


@contextmanager
def trace(stage: str, **extra):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        info = "  ".join(f"{k}={v}" for k, v in extra.items())
        print(f"[fpmash] {stage}: {dt:.3f}s  {info}".rstrip(), file=sys.stderr)
