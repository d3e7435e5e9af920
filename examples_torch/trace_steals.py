"""Trace a 3-engine work-stealing pool on the card and export a Chrome
trace.

A burst of GEMMs is submitted with affinity to ONE engine of a
heterogeneous 3-engine pool, so the other two engines must steal their
share — every seed, enqueue, dequeue, steal, and panel execution lands
on one :class:`repro_torch.obs.Tracer`, which is then exported as Chrome
``trace_event`` JSON.  Open the file in ``chrome://tracing`` or
https://ui.perfetto.dev to see one timeline track per engine with panel
spans and steal markers.  The pool is the paper's simulated PEs (F-PE,
S-PE, NEON), which run the plain fp32 GEMM on the run's device.

    PYTHONPATH=src python examples_torch/trace_steals.py [out.json] \
        [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.job import JobSet  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.obs import (Tracer, parse_prometheus,  # noqa: E402
                             render_prometheus, validate_events)
from repro_torch.soc import SynergyRuntime  # noqa: E402

ENGINES = ("F-PE", "S-PE", "NEON")


def run(device="cuda", *, out_path: str = "results/trace_steals_torch.json",
        bursts: int = 12) -> dict:
    """The traced burst: returns every printed figure, the validation
    errors and the Prometheus text."""
    dev = resolve_device(device)
    tracer = Tracer(capacity=100_000)
    a = torch.ones(128, 32, device=dev)
    b = torch.ones(32, 32, device=dev)
    with SynergyRuntime(list(ENGINES), name="trace-demo", tracer=tracer,
                        device=dev) as rt:
        # everything seeds onto F-PE; S-PE and NEON must steal to help
        futs = [rt.submit_gemm(
            a, b, jobset=JobSet.for_gemm(s, 128, 32, 32, 32,
                                         name=f"burst{s}"),
            tile=(32, 32, 32), affinity="F-PE") for s in range(bursts)]
        ys = [f.result(60) for f in futs]
        stats = rt.stats()
        prom = render_prometheus(runtime=rt)

    events = tracer.events()
    steals = [e for e in events if e.kind == "steal"]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    written = tracer.export_chrome_trace(out_path)
    return {
        "device": device_label(dev),
        "events": len(events),
        "counts": dict(sorted(tracer.counts().items())),
        "kinds": sorted({e.kind for e in events}),
        "errors": validate_events(events, engines=set(ENGINES)),
        "steals": [(e.ts, e.track, e.tags["victim"], e.tags["jobset"])
                   for e in steals],
        "engines": {name: {"jobs": es["jobs"], "steals": es["steals"],
                           "busy_fraction": es["busy_fraction"]}
                    for name, es in stats["engines"].items()},
        "outputs_right": all(bool(torch.all(y == 32.0)) for y in ys),
        "chrome_events": written, "out_path": out_path,
        "prometheus": prom,
        "metric_names": sorted(parse_prometheus(prom)),
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?",
                    default="results/trace_steals_torch.json",
                    help="where the Chrome trace goes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, out_path=args.out)
    print(f"recorded {out['events']} events on {out['device']}: "
          + ", ".join(f"{k}={v}" for k, v in out["counts"].items()))
    for ts, track, victim, jobset in out["steals"][:8]:
        print(f"  steal @ {ts:.6f}s: {track} <- {victim} ({jobset})")
    if len(out["steals"]) > 8:
        print(f"  ... and {len(out['steals']) - 8} more steals")
    for name, es in out["engines"].items():
        print(f"  {name}: jobs={es['jobs']} steals={es['steals']} "
              f"busy={es['busy_fraction']:.2f}")
    print(f"wrote {out['chrome_events']} Chrome trace events -> "
          f"{out['out_path']}")
    print("open it in chrome://tracing or https://ui.perfetto.dev")
    print("\n--- Prometheus exposition (first 12 lines) ---")
    print("\n".join(out["prometheus"].splitlines()[:12]))

    failures = [f"trace: {e}" for e in out["errors"]]
    if not out["outputs_right"]:
        failures.append("a burst GEMM of ones is not 32 everywhere")
    print(json.dumps({"example": "trace_steals",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
