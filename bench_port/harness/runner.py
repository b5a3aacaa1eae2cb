"""One run of one cell: set-up, the measured window, the check, the result line.

The window drives the port's CLI entry ``fpmash_tpu_torch.cli.main(argv)`` in
this process, one call a step of a job, job after job, closed loop, one client.  It opens at the first
job and closes at the end of the first job that ends after ``seconds``, so
every job in it is whole.  Set-up (``setup_s``) runs from the process's start
to the first timed job: imports, the port's build or load of its libraries,
the inputs made from the seed, and one warm job of the cell's shapes.
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

from bench_port.harness import check, spec, tracing, traffic

#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fpmash_tpu")


def _argv(template: list[str], values: dict, inputs: list[str]) -> list[str]:
    """A step's argv: ``{inputs}`` alone is every input of the job, and any
    other token is formatted from the configuration, the traffic's
    ``expect``, ``dir`` (the job's output folder), ``device`` and ``inputs``
    (so ``{inputs[1]}`` is the job's second input)."""
    out = []
    for tok in template:
        if tok == "{inputs}":
            out.extend(inputs)
        else:
            out.append(tok.format(**values, inputs=inputs))
    return out


def _counters() -> dict:
    """Every launch counter of the port's loaded modules (``*LAUNCHES``)."""
    out = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("fpmash_tpu_torch.") or module is None:
            continue
        for attr, value in vars(module).items():
            if not attr.endswith("LAUNCHES"):
                continue
            if isinstance(value, int):
                out[f"{name}.{attr}"] = value
            elif isinstance(value, dict):
                out.update({f"{name}.{attr}.{k}": v for k, v in value.items()
                            if isinstance(v, int)})
    return out


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile, interpolated linearly between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class ProgramStep:
    """A step of a job as a user runs it: the CLI's ``main`` on its argv,
    its standard output kept where the step's output is ``-``."""

    def __init__(self, device: str, stderr):
        from fpmash_tpu_torch import cli

        self.main, self.device, self.stderr = cli.main, device, stderr

    def __call__(self, argv: list[str], keep_stdout: bool) -> tuple[int, bytes | None]:
        import torch

        sink = io.StringIO() if keep_stdout else open(os.devnull, "w")
        with sink, contextlib.redirect_stdout(sink), contextlib.redirect_stderr(self.stderr):
            rc = self.main(argv)
            if self.device == "cuda":
                torch.cuda.synchronize()
            text = sink.getvalue().encode() if keep_stdout else None
        return rc, text


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: float | None = None) -> dict:
    """Run ``cell`` once; return the result line's object.

    A job runs the traffic's ``steps`` in order, each one call of the CLI
    (``argv``), and stops at a step that fails.  A step's ``output`` is the
    file it writes in the job's folder, or ``-`` for its standard output;
    where the step names a ``check``, the output is read back after the job
    and judged once the window has closed (``harness/check.py``)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cfg, tr = cell.config, cell.traffic
    steps = tr["steps"]
    work = Path(tempfile.mkdtemp(prefix="bench_port_"))
    try:
        pool, rng = traffic.make_pool(tr, seed, work, cell.root)
        jobs = pool.jobs(rng)
        job_dir = work / "job"
        job_dir.mkdir()
        files = [None if st["output"] == "-" else job_dir / st["output"] for st in steps]
        values = {**cfg, **tr.get("expect", {}), "dir": str(job_dir), "device": device}
        stamped = tracing.StampedLines()  # holds the port's span lines, if it prints any
        run_step = ProgramStep(device, stamped)
        outputs = check.Outputs(steps, cell.root)
        failures: list[str] = []

        def one(job):
            inputs = [str(pool.items[i].path) for i in job]
            for f in files:
                if f is not None:
                    f.unlink(missing_ok=True)
            kept, rc = [], 0
            t_start = time.perf_counter()
            for st, f in zip(steps, files):
                try:
                    rc, text = run_step(_argv(st["argv"], values, inputs), f is None)
                except (Exception, SystemExit):  # a job that fails is counted; the run goes on
                    rc, text = -1, None
                    failures.append(traceback.format_exc())
                kept.append(text)
                if rc != 0:
                    break
            t_end = time.perf_counter()
            data = [text if f is None else (f.read_bytes() if f.exists() else None)
                    for text, f in zip(kept + [None] * (len(steps) - len(kept)), files)]
            return t_start, t_end, rc, data

        one(next(jobs))  # warm: every shape of the cell, in set-up
        stamped.lines.clear()
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
        before = _counters()
        prof = tracing.Profiler(str(work)) if trace and device == "cuda" else None
        t_marker = prof.start() if prof else None
        setup_s = time.perf_counter() - t0
        done = []
        t_open = None
        while True:
            job = next(jobs)
            t_start, t_end, rc, data = one(job)
            t_open = t_start if t_open is None else t_open
            done.append((job, t_end - t_start, rc))
            for i, d in enumerate(data):
                outputs.add(i, job, d)
            if t_end - t_open >= seconds:
                break
        t_close = t_end
        dev_trace = prof.stop(t_marker, t_open, t_close) if prof else None
        after = _counters()
        window_s = t_close - t_open
        mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        del run_step
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        reference = check.Reference(pool, cfg, tr.get("expect", {}), device, root=cell.root)
        numbers = outputs.check(reference)
        check_s = time.perf_counter() - t_check
        bases = sum(pool.items[i].bases for job, _, _ in done for i in job)
        failed = sum(rc != 0 for _, _, rc in done)
        run = SimpleNamespace(
            config=cfg, traffic=tr, pool=pool, jobs=[j for j, _, _ in done], bases=bases,
            window_s=window_s, t_open=t_open, t_close=t_close, reference=reference,
            spans=stamped.spans(), device=dev_trace,
            counters={k: after.get(k, 0) - before.get(k, 0) for k in after},
        )
        e2e = {
            "bases_per_s": lambda: bases / window_s,
            "job_p95_ms": lambda: 1e3 * percentile([t for _, t, _ in done], 95),
            "setup_s": lambda: setup_s,
        }
        metrics = {}
        if not trace:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
        else:
            for m in cell.per_layer:
                value = spec.reader(m["name"], cell.root)(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
               "count": cell.chips, "memory_peak_bytes": mem_peak}
        limits = outputs.limits
        result = {
            "correct": failed == 0 and outputs.seen > 0
                       and all(numbers[k] <= limits[k] for k in limits),
            "attempted": len(done), "failed": failed, "metrics": metrics, "device": dev,
        }
        if trace and dev_trace is not None:
            dev["busy_s"] = dev_trace.busy_s()
            dev["window_s"] = window_s
            result["breakdown"] = tracing.breakdown(dev_trace, run.spans, t_open, t_close)
        result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
        result["_failures"] = failures[:1]
        times = sorted(1e3 * t for _, t, _ in done)
        result["_notes"] = (f"{len(done)} jobs in {window_s:.3f} s (job ms: min {times[0]:.1f}, "
                            f"median {percentile(times, 50):.1f}, p95 {percentile(times, 95):.1f}, "
                            f"max {times[-1]:.1f}), set-up {setup_s:.3f} s, reference check "
                            f"{check_s:.3f} s of {outputs.seen} outputs")
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
