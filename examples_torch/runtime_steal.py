"""SynergyRuntime demo on the card: one workload, live engines, jobs that
migrate.

Shows the paper's §4.3 thief protocol on real threads: a ThreadedPipeline
whose GEMM stage is *pinned* to F-PE runs under a runtime scope, so the pin
is only a queue-affinity hint — the idle S-PE steals row-panel tile jobs
from F-PE's deque and the merged result is unchanged.  Then an engine is
hot-plugged mid-run (register_engine -> live rebalance) and retired again.
F-PE and S-PE are the paper's simulated PEs: they run the plain fp32 GEMM
on the run's device, paced by nothing, so no hand-written kernel runs here.

    PYTHONPATH=src python examples_torch/runtime_steal.py [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.job import JobSet  # noqa: E402
from repro_torch.core.pipeline import (EngineStage,  # noqa: E402
                                       ThreadedPipeline)
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.engines import registered  # noqa: E402
from repro_torch.engines.sim import (SIM_ENGINE_SPECS,  # noqa: E402
                                     SimPEEngine)
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.soc import SimRuntime, SynergyRuntime  # noqa: E402


def run(device="cuda", *, frames: int = 8, rows: int = 320) -> dict:
    """The pinned pipeline, the same stages under a two-PE runtime, the
    hot-plug, and the virtual-time twin.  Returns every printed figure."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(64, 48, generator=g, device=dev)
    xs = [torch.randn(rows, 64, generator=g, device=dev)
          for _ in range(frames)]
    stages = [EngineStage.gemm("mm", w, engine="F-PE", tile=(32, 32, 32)),
              ("post", lambda y: float(torch.sum(y)))]

    # --- pinned vs runtime ------------------------------------------------
    pinned_out, pinned = ThreadedPipeline(stages).run(xs)
    with SynergyRuntime(["F-PE", "S-PE"], name="demo", device=dev) as rt, \
            rt.scope():
        rt_out, st = ThreadedPipeline(stages).run(xs)
        stats = st["runtime"]

        # --- hot-plug an engine mid-run (live rebalance) ------------------
        boosted = SimPEEngine("X-PE", SIM_ENGINE_SPECS["F-PE"].scaled(4.0))
        rt2 = SynergyRuntime(["F-PE", "S-PE"], follow_registry=True,
                             name="hotplug", device=dev).start()
        try:
            with registered(boosted):        # register_engine -> pool grows
                hotplug = list(rt2.engine_names)
            unplug = list(rt2.engine_names)
        finally:
            rt2.shutdown()

    # --- virtual-time conformance twin ------------------------------------
    js = JobSet.for_gemm(0, rows, 48, 64, 32, name="mm")
    sim = SimRuntime(["F-PE", "S-PE"]).run(js, affinity="F-PE")
    return {
        "device": device_label(dev),
        "pinned_fps": pinned["fps"],
        "runtime_fps": st["fps"],
        "total_steals": stats["total_steals"],
        "aggregate_busy_fraction": stats["aggregate_busy_fraction"],
        "engines": {name: {"jobs": s["jobs"], "steals": s["steals"],
                           "busy_fraction": s["busy_fraction"]}
                    for name, s in stats["engines"].items()},
        "outputs_equal": pinned_out == rt_out,
        "hotplug_pool": hotplug, "unplug_pool": unplug,
        "sim_jobs": dict(sim.per_engine_jobs),
        "sim_steals": dict(sim.per_engine_steals),
        "sim_busy_fraction": sim.aggregate_busy_fraction,
        "sim_jobset_jobs": js.num_jobs,
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(f"pinned   : {out['pinned_fps']:6.1f} fps, all jobs on F-PE "
          f"({out['device']})")
    print(f"runtime  : {out['runtime_fps']:6.1f} fps, "
          f"steals={out['total_steals']}, "
          f"agg busy fraction={out['aggregate_busy_fraction']:.2f}")
    for name, s in out["engines"].items():
        print(f"  {name:<5s} jobs={s['jobs']:<3d} steals={s['steals']:<3d} "
              f"busy={s['busy_fraction']:5.1%}")
    print(f"  pipeline outputs equal the pinned run's: "
          f"{out['outputs_equal']}")
    print(f"\nhot-plug : pool={out['hotplug_pool']}")
    print(f"unplug   : pool={out['unplug_pool']}")
    print(f"\nSimRuntime (virtual time, same steal policy as the DES): "
          f"jobs={out['sim_jobs']} steals={out['sim_steals']} "
          f"busy fraction={out['sim_busy_fraction']:.2f}")

    failures = []
    if not out["outputs_equal"]:
        failures.append("the runtime's outputs differ from the pinned run's")
    if sorted(out["hotplug_pool"]) != ["F-PE", "S-PE", "X-PE"] or sorted(
            out["unplug_pool"]) != ["F-PE", "S-PE"]:
        failures.append("the hot-plugged engine did not join and leave")
    if sum(out["sim_jobs"].values()) != out["sim_jobset_jobs"]:
        failures.append(f"SimRuntime ran {out['sim_jobs']} of "
                        f"{out['sim_jobset_jobs']} jobs")
    print(json.dumps({"example": "runtime_steal",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
