"""What the traced run reads: the port's spans, and the device's activity.

Spans: with ``FPMASH_TRACE=1`` set before the port is imported, its
``utils/trace.py`` prints ``[fpmash] <stage>: <seconds>s  <extra>`` on
standard error when a stage ends.  :class:`StampedLines` takes the job's
standard error and stamps each line with the host clock as it arrives, so a
span is ``(name, end - seconds, end)`` on the harness's clock.

Device: ``torch.profiler`` traces the window (CUDA activity through CUPTI);
the chrome trace it exports gives every kernel, copy and fill on the card,
which a marker recorded at the window's open puts on the host clock.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
from dataclasses import dataclass

_SPAN = re.compile(r"^\[fpmash\] (.+?): (\d+\.\d+)s(?:\s|$)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "bench_port.window_open"


@dataclass
class Span:
    name: str
    start: float
    end: float


class StampedLines(io.TextIOBase):
    """A text sink that keeps the ``[fpmash]`` lines with their arrival time."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._buf = ""
        self._t = 0.0

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        if not self._buf:
            self._t = time.perf_counter()
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.startswith("[fpmash] "):
                self.lines.append((self._t, line))
            self._t = time.perf_counter()
        return len(text)

    def spans(self) -> list[Span]:
        out = []
        for t, line in self.lines:
            m = _SPAN.match(line)
            if m:
                out.append(Span(m.group(1), t - float(m.group(2)), t))
        return out


@dataclass
class DeviceTrace:
    """Device activity inside the window, on the host clock: intervals of
    every op, and each kernel's name and duration."""

    ops: list[tuple[float, float, str, str]]  # start, end, category, name

    def busy(self) -> list[tuple[float, float]]:
        return union([(s, e) for s, e, _, _ in self.ops])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_s(self) -> float:
        return sum(e - s for s, e, cat, _ in self.ops if cat == "kernel")


def union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class Profiler:
    """``torch.profiler`` around the window, read back as a :class:`DeviceTrace`."""

    def __init__(self, tmpdir: str):
        import torch

        self._torch = torch
        self.path = os.path.join(tmpdir, "bench_port_trace.json")
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])

    def start(self) -> float:
        """Start tracing; return the host time of the window's marker."""
        self.prof.__enter__()
        t = time.perf_counter()
        with self._torch.profiler.record_function(MARKER):
            pass
        return t

    def stop(self, t_marker: float, t_open: float, t_close: float) -> DeviceTrace:
        self._torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as fh:
            events = json.load(fh)
        os.unlink(self.path)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        marker = [e for e in events if e.get("name") == MARKER and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
        if not marker:
            raise RuntimeError("the profiler's trace lacks the window's marker")
        offset = t_marker - float(marker[0]["ts"]) * 1e-6
        ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s = float(e["ts"]) * 1e-6 + offset
            d = float(e.get("dur", 0.0)) * 1e-6
            s, t = max(s, t_open), min(s + d, t_close)
            if t > s:
                ops.append((s, t, e["cat"], str(e.get("name", ""))))
        return DeviceTrace(ops)


def op_name(name: str) -> str:
    """A device op's name as the breakdown gives it: letters, digits and
    ``_.-`` only, at most 64 of them."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name).strip("_")[:64] or "op"


def breakdown(trace: DeviceTrace, spans: list[Span], t_open: float, t_close: float) -> dict:
    """The device ops that took most time, and the longest idle time by the
    innermost host span open at the time (``between_spans`` where none is)."""
    by_op: dict[str, float] = {}
    for s, e, _, name in trace.ops:
        key = op_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    idle = _complement(trace.busy(), t_open, t_close)
    by_span: dict[str, float] = {}
    for name, dt in _attribute(idle, spans):
        by_span[name] = by_span.get(name, 0.0) + dt
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def _complement(busy, t0: float, t1: float):
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def _attribute(intervals, spans: list[Span]):
    """``(span name, seconds)`` pieces of ``intervals``: each piece goes to
    the shortest span open at the time, the innermost one (a parent's start,
    rounded to the millisecond as the port prints it, can fall after its
    child's)."""
    cuts = sorted({t for s in spans for t in (s.start, s.end)})
    by_start = sorted(spans, key=lambda s: s.start)
    j, open_ = 0, []
    points = sorted({*cuts, *(t for iv in intervals for t in iv)})
    iv_i = 0
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        while j < len(by_start) and by_start[j].start <= mid:
            open_.append(by_start[j])
            j += 1
        open_ = [s for s in open_ if s.end > mid]
        while iv_i < len(intervals) and intervals[iv_i][1] <= mid:
            iv_i += 1
        if iv_i < len(intervals) and intervals[iv_i][0] <= mid:
            owner = min(open_, key=lambda s: s.end - s.start).name if open_ else "between_spans"
            yield owner, b - a
