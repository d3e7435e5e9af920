"""What the CNN path's layer spans cost the host, on the card.

One cell of the benchmark (its set-up from ``bench/``: weights, frames,
the closed loop with its batches in flight) runs windows of a fixed
number of batches in turns, in three modes:

- ``off``: no tracer installed, no profiler: every span is a flag check;
- ``tracer``: a ``Tracer`` installed (spans record, with CUDA events);
- ``device``: a ``torch.profiler`` session of CUDA activity alone, as the
  benchmark's device window (spans record into the profiled recorder,
  none is mirrored).

Each window prints frames/s, the median host time of the entry point
(``cnn_forward``, on the host clock) and, where spans record, the median
``cnn.forward`` span (the traced host time set beside the untraced one)
and each span's self time (its duration less its children's), in ms a
forward: where the host's time goes.

    python3 scripts/span_cost.py --workload alexplus.fp32_b256 \\
        --seed 3600000001 --batches 300 --rounds 4
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

MODES = ("off", "tracer", "device")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="alexplus.fp32_b256")
    ap.add_argument("--seed", type=int, default=3600000001)
    ap.add_argument("--batches", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchkit import traffic as traffic_mod
    from benchkit.manifest import Bench
    from repro_torch.obs import trace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    driver, loop = bench.driver(cell.driver), bench.loop(cell.loop)
    mix = traffic_mod.check_mix(cell.traffic, loop, driver)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    setup = driver.setup(cell.config, mix, args.seed, dev,
                         bench.reference(cell.reference))
    host: list[float] = []
    entry = setup.entry

    def timed(i):
        t0 = time.perf_counter()
        out = entry(i)
        host.append(time.perf_counter() - t0)
        return out
    setup.entry = timed
    offered = loop.make(setup, mix, dev)
    offered.warmup()
    torch.cuda.synchronize()

    def window(mode: str) -> dict:
        host.clear()
        recorder = trace.profiled_tracer()
        recorder.clear()
        tracer = trace.Tracer(capacity=1 << 17)
        if mode == "off":
            ctx = contextlib.nullcontext()
        elif mode == "tracer":
            ctx = trace.trace_scope(tracer)
        else:
            ctx = profile(activities=[ProfilerActivity.CUDA])
        with ctx:
            w = offered.window(count=args.batches)
            torch.cuda.synchronize()
        spans = {"off": [], "tracer": tracer.events(),
                 "device": recorder.events()}[mode]
        spans = [e for e in spans if e.kind in trace.SPAN_NAMES]
        forwards = [e.dur for e in spans if e.kind == "cnn.forward"]
        kinds = {e.tags["id"]: e.kind for e in spans}
        self_s = dict.fromkeys(sorted(trace.SPAN_NAMES), 0.0)
        for e in spans:
            self_s[e.kind] += e.dur
            if e.tags["parent"] in kinds:
                self_s[kinds[e.tags["parent"]]] -= e.dur
        return {"mode": mode,
                "frames_per_s": mix["batch"] * len(w.batches) / w.seconds,
                "host_ms": 1e3 * statistics.median(host),
                "span_ms": (1e3 * statistics.median(forwards)
                            if forwards else None),
                "self_ms": ({k: 1e3 * v / len(forwards)
                             for k, v in self_s.items()} if forwards
                            else None),
                "forwards": len(forwards)}

    rows = []
    for r in range(args.rounds):
        for mode in MODES[r % 3:] + MODES[:r % 3]:
            rows.append(window(mode))
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for mode in MODES:
        mine = [x for x in rows if x["mode"] == mode]
        summary[mode] = {k: statistics.median(x[k] for x in mine)
                         for k in ("frames_per_s", "host_ms")}
        if mode != "off":
            summary[mode]["span_ms"] = statistics.median(
                x["span_ms"] for x in mine)
            summary[mode]["self_ms"] = {
                k: statistics.median(x["self_ms"][k] for x in mine)
                for k in sorted(trace.SPAN_NAMES)}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "batches": args.batches, "medians": summary}))


if __name__ == "__main__":
    main()
