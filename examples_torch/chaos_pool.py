"""Chaos demo on the card: kill an engine mid-run and watch the pool
recover.

A 3-engine pool serves waves of GEMM submissions.  A deterministic
:class:`~repro_torch.soc.FaultPlan` (seed-reproducible — rerun the script
and the SAME faults hit at the SAME calls) injects two transient panel
exceptions on one engine and then KILLS another engine's worker thread
mid-wave.  The runtime's :class:`~repro_torch.soc.RetryPolicy` absorbs all
of it: failed panels re-seed onto surviving engines, the heartbeat monitor
declares the dead worker and re-seeds its orphaned panels, and every
merged output stays bitwise identical to the fault-free answer — faults
cost retries, never ULPs.

The three engines are this example's own stand-ins for uneven silicon
(``PacedEngine``: a sleep by its cost model, then ``torch.matmul`` on the
run's device); no hand-written kernel runs here.

    PYTHONPATH=src python examples_torch/chaos_pool.py [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.job import JobSet  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.engines import CAP_GEMM, CostModel, Engine  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.soc import (FaultPlan, FaultSpec, RetryPolicy,  # noqa: E402
                             SynergyRuntime, wrap_pool)

M, K, N, TILE = 256, 64, 48, (32, 32, 32)
WAVES = 12


class PacedEngine(Engine):
    """Identical fp32 math on every instance, paced by the cost model so
    the pool behaves like real heterogeneous silicon."""

    def __init__(self, name, macs_per_s):
        super().__init__(name, {CAP_GEMM, "epilogue"},
                         cost=CostModel(macs_per_s=macs_per_s))

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        m, k = a.shape
        time.sleep(m * k * b.shape[1] / self.cost.macs_per_s)
        y = torch.matmul(a.to(torch.float32), b.to(torch.float32))
        return y.to(out_dtype or a.dtype)


def pool():
    return [PacedEngine("cp-a", 4e7), PacedEngine("cp-b", 4e7),
            PacedEngine("cp-c", 2e7)]


def run_waves(rt, base, a, b, waves):
    outs = []
    for i in range(waves):
        fut = rt.submit_gemm(
            a, b, jobset=JobSet.for_gemm(base + i, M, K, N, 32,
                                         name=f"wave{base + i}"),
            tile=TILE)
        outs.append(fut.result(120))
    return outs


def run(device="cuda", *, waves: int = WAVES) -> dict:
    """A warm-up, a clean run and a chaos run of ``waves`` GEMMs each;
    returns every printed figure."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(M, K, generator=g, device=dev)
    b = torch.randn(K, N, generator=g, device=dev)
    retry = RetryPolicy(max_attempts=4, heartbeat_timeout_s=0.2,
                        monitor_interval_s=0.05)

    with SynergyRuntime(pool(), name="warm", retry=retry, device=dev) as rt:
        run_waves(rt, 900, a, b, waves)      # warm-up, untimed
    t0 = time.perf_counter()
    with SynergyRuntime(pool(), name="clean", retry=retry, device=dev) as rt:
        clean = run_waves(rt, 0, a, b, waves)
    clean_s = time.perf_counter() - t0

    plan = FaultPlan((
        FaultSpec("cp-b", "raise", at_call=1, count=2),   # transient panics
        FaultSpec("cp-c", "die", at_call=4),              # worker crash
    ), seed=13)
    t0 = time.perf_counter()
    with SynergyRuntime(wrap_pool(pool(), plan), name="chaos", retry=retry,
                        device=dev) as rt:
        chaos = run_waves(rt, 100, a, b, waves)
        stats = rt.stats()
    chaos_s = time.perf_counter() - t0
    return {
        "device": device_label(dev), "waves": waves,
        "clean_s": clean_s, "chaos_s": chaos_s,
        "injected": [(e, k, c) for e, k, c in plan.injected],
        "retries": stats["retries"], "worker_deaths": stats["worker_deaths"],
        "orphan_reseeds": stats["orphan_reseeds"],
        "bitwise": all(torch.equal(c, f) for c, f in zip(clean, chaos)),
        "outputs": [c.cpu() for c in chaos],
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    waves = out["waves"]
    print(f"clean run (no faults) on {out['device']}...")
    print(f"  {waves} waves in {out['clean_s']:.2f}s\n")
    print("chaos run: 2 injected panel exceptions on cp-b, then cp-c's "
          "worker is killed mid-wave...")
    print(f"  {waves} waves in {out['chaos_s']:.2f}s on the wounded pool")
    print(f"  injected        : {out['injected']}")
    print(f"  panel retries   : {out['retries']}")
    print(f"  worker deaths   : {out['worker_deaths']}")
    print(f"  orphan re-seeds : {out['orphan_reseeds']}")
    print(f"  outputs bitwise identical to clean run: {out['bitwise']}")
    print(f"\nrecovered throughput: {waves / out['chaos_s']:.1f} waves/s vs "
          f"{waves / out['clean_s']:.1f} clean "
          f"({out['clean_s'] / out['chaos_s']:.2f}x)")

    failures = []
    if not out["bitwise"]:
        failures.append("fault recovery changed the math")
    if out["worker_deaths"] != 1 or out["retries"] < 2:
        failures.append(f"{out['worker_deaths']} worker deaths and "
                        f"{out['retries']} retries, not 1 and at least 2")
    print(json.dumps({"example": "chaos_pool",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
