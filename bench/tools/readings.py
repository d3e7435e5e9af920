"""The readings a cell's limits are set from: the numbers compared, from
runs of the program on many seeds and from runs of the control (the plain
reference at the precision just below the configuration's, in the
program's place) on a few, all in one process so that the card is reached
once.  Not part of a benchmark run.

    python3 bench/tools/readings.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 --control tf32 --control-seeds 4,5,6 --out <file>

Writes one JSON object: each run's seed, kind and readings.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main() -> int:
    from benchkit.manifest import Bench
    from benchkit.runner import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    bench = Bench(ROOT)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    runs = []
    plan = [("program", s) for s in seeds(args.seeds)] + \
        [(f"control_{args.control}", s) for s in seeds(args.control_seeds)]
    for kind, seed in plan:
        hook = None
        if kind != "program":
            def hook(setup):
                setup.entry = setup.control(args.control)
        t = time.perf_counter()
        r = run_cell(bench, args.workload, seed, args.seconds, False,
                     t0=t, setup_hook=hook)
        runs.append({"kind": kind, "seed": seed, "correct": r["correct"],
                     "checks": r["checks"], "attempted": r["attempted"],
                     "wall_s": time.perf_counter() - t,
                     "device": r["device"]})
        print(json.dumps(runs[-1]), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
