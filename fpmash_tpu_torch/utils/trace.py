"""Stage tracing of the port: spans on standard error and in memory.

Switched on by ``FPMASH_TRACE`` (any non-empty value) when this module is
imported, and at run time by :func:`enable`.  While it is on, every traced
stage (``with trace(stage, **extra):``) prints
``[fpmash] <stage>: <seconds>s  <extra>`` to stderr as it ends (seconds to 3
decimals), and is kept in memory as a :class:`Span`: its name, its start and
end as ``time.perf_counter()`` values, the id of the span it opened inside,
its job (the id of the outermost ``command:*`` span around it), its
``extra`` attributes and its counters (:func:`count`).  :func:`spans` gives
the kept spans, in the order they ended; at most :data:`CAP` are kept and
:func:`dropped` counts the rest until :func:`clear`.

While it is off, :func:`trace` and :func:`count` return at once: no clock is
read and nothing is kept.  Host clock only: a stage that launches device
work is timed up to the point where its results reach the host.  Spans nest
on one stack, so stages are traced from one thread.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import nullcontext

#: the most spans kept in memory; later ones are counted by :func:`dropped`
CAP = 1 << 20

_ENABLED = bool(os.environ.get("FPMASH_TRACE"))
_OFF = nullcontext()
_open: list["Span"] = []  # the spans open now, innermost last
_kept: list["Span"] = []
_dropped = 0
_last_id = 0


class Span:
    """One traced stage, and the context manager that times it."""

    __slots__ = ("id", "name", "start", "end", "parent", "job", "extra", "counters")

    def __init__(self, name: str, extra: dict):
        self.name, self.extra, self.counters = name, extra, {}
        self.id = self.parent = self.job = self.start = self.end = None

    def __enter__(self) -> "Span":
        global _last_id
        _last_id += 1
        up = _open[-1] if _open else None
        self.id = _last_id
        self.parent = up.id if up else None
        self.job = up.job if up else None
        if self.job is None and self.name.startswith("command:"):
            self.job = self.id
        _open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end = time.perf_counter()
        _open.remove(self)  # a generator's span may close after its caller's
        if len(_kept) < CAP:
            _kept.append(self)
        else:
            _dropped += 1
        info = "  ".join(f"{k}={v}" for k, v in self.extra.items())
        print(f"[fpmash] {self.name}: {self.end - self.start:.3f}s  {info}".rstrip(),
              file=sys.stderr)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, job={self.job}, "
                f"start={self.start}, end={self.end}, extra={self.extra}, "
                f"counters={self.counters})")


def trace(stage: str, **extra):
    """A context manager that traces ``stage`` (a shared no-op while off)."""
    if not _ENABLED:
        return _OFF
    return Span(stage, extra)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    if _ENABLED and _open:
        counters = _open[-1].counters
        counters[name] = counters.get(name, 0) + n


def enable(on: bool = True) -> None:
    """Switch tracing on or off from now on."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def spans() -> list[Span]:
    """The kept spans, in the order they ended."""
    return list(_kept)


def dropped() -> int:
    """Spans that ended while :data:`CAP` spans were kept."""
    return _dropped


def clear() -> None:
    """Forget the kept spans and the count of dropped ones."""
    global _dropped
    _kept.clear()
    _dropped = 0
