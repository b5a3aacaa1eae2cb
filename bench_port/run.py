"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The cell's configuration, traffic and per-layer metrics are found by name
from ``BENCHMARK.json`` and the files under ``bench_port/``.  The last line of
standard output is the result as one JSON object; the last lines of standard
error are the numbers that decide ``correct``, each beside its limit.  With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and a breakdown.
Without enough usable CUDA cards it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port.harness import spec

    cell = spec.load_cell(args.workload)
    # before the port is imported: its spans switch on at import, and its
    # kernel caches must lie at fixed paths inside this checkout
    if args.trace:
        os.environ["FPMASH_TRACE"] = "1"
    else:
        os.environ.pop("FPMASH_TRACE", None)
    os.environ["FPMASH_DEVICES"] = str(cell.chips)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_port" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_port" / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from bench_port.harness.runner import forbidden_modules, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    for tb in result.pop("_failures"):
        print(f"bench_port: a job failed:\n{tb}", file=sys.stderr)
    print(f"bench_port: {cell.name} seed {args.seed}: {result.pop('_notes')}; card "
          f"{torch.cuda.get_device_name(0)}, power limit {_power_limit()}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
