"""The control of a cell's check: the plain reference in the program's place,
computed one precision down, must come out as not correct.

    python3 bench_port/control.py --workload <name> --seeds <n> [<n> ...] --jobs <count>

For each seed it makes the cell's inputs and draws the warm job and then
``--jobs`` jobs as a run does.  Each step of each job that a run checks gets,
in place of the program's output, the answer its check module renders from
the reference at the precision below the configuration's (the sketcher says
which: 32-bit k-mer hashes where 64 are stated; factor lengths hashed as
32-bit words where fp-mash hashes 64-bit ones).  These go through the run's
own comparison (``harness/check.py``) against the reference at full
precision, and one JSON line a seed gives the numbers compared.  On the card
(``--device cuda``, the default) as a run's check is; the program is not run.
"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control(cell, seed: int, jobs: int, device: str) -> dict:
    """The numbers a run's check gives the control's answers for ``jobs`` jobs."""
    from bench_port.harness import check, traffic

    work = Path(tempfile.mkdtemp(prefix="bench_port_control_"))
    try:
        pool, rng = traffic.make_pool(cell.traffic, seed, work, cell.root)
        draws = pool.jobs(rng)
        next(draws)  # the warm job
        steps, expect = cell.traffic["steps"], cell.traffic.get("expect", {})
        low = check.Reference(pool, cell.config, expect, device, control=True, root=cell.root)
        outputs = check.Outputs(steps, cell.root)
        for _ in range(jobs):
            job = next(draws)
            for i, c in enumerate(outputs.checks):
                if c is not None:
                    outputs.add(i, job, c.render(c.expected(low, check.groups(steps[i], job)), low))
        numbers = outputs.check(check.Reference(pool, cell.config, expect, device,
                                                root=cell.root))
        correct = outputs.seen > 0 and all(numbers[k] <= outputs.limits[k] for k in numbers)
        return {"correct": correct, "check": numbers}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bench_port.harness import spec

    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        r = control(cell, seed, args.jobs, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "jobs": args.jobs, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
