"""One run of one cell: set-up, warm-up, the measured window, the traced
windows (``--trace 1``), the check against the plain reference, and the
result line.

A run whose set-up built any of the program's kernels (the first in a
checkout) says so under the result's ``setup`` key, with the kernels it
built: its ``setup_s`` holds the build, and is recorded apart from the
runs that find every kernel built.

The run refuses to start without a CUDA card (it never falls back to the
CPU) unless a caller passes ``device="cpu"``, as the CPU tests do to drive
the rest of a run at a small size.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import stats, trace, traffic as traffic_mod
from .manifest import Bench
from .readers import Reading

__all__ = ["FORBIDDEN", "forbidden_modules", "card_info", "run_cell",
           "built_kernels", "NoCard"]

#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package the port was made from (compared whole: ``repro_torch``
#: is the program)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_info(chips: int) -> dict:
    """The card's name, the count used, and its power limit, or raises
    :class:`NoCard`."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card is available: the benchmark runs on the "
                     "card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} are available")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def built_kernels(root: Path) -> set[str]:
    """The program's kernels built in the checkout: the libraries under
    ``build/kernels/``, where ``repro_torch.kernels.common.build`` keeps
    them."""
    return {p.name for p in (Path(root) / "build" / "kernels").glob("*.so")}


def _end_to_end(bench: Bench, name: str, window, counts: dict) -> float:
    spec = bench.statistic(name)
    if isinstance(spec, dict):
        return stats.value(spec, window, counts)
    return spec.value(window, counts)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace_on: bool, *, t0: float, device: str = "cuda",
             log=lambda msg: print(msg, file=sys.stderr, flush=True),
             setup_hook=None) -> dict:
    """One run; returns the result line's object.  ``setup_hook(setup)``,
    where given, may replace parts of the set-up (the tests' faults and
    controls) before the warm-up."""
    cell = bench.cell(workload)
    driver = bench.driver(cell.driver)
    loop = bench.loop(cell.loop)
    mix = traffic_mod.check_mix(cell.traffic, loop, driver)
    dev = torch.device(device)
    info = card_info(cell.entry.get("chips", 1)) if dev.type == "cuda" \
        else {"platform": "cpu", "kind": "CPU", "count": 1}
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    built = built_kernels(bench.root)
    setup = driver.setup(cell.config, mix, seed, dev,
                         bench.reference(cell.reference))
    if setup_hook is not None:
        setup_hook(setup)
    offered = loop.make(setup, mix, dev)
    offered.warmup()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    built = sorted(built_kernels(bench.root) - built)
    log(f"bench: {workload} seed {seed}: set-up {setup_s:.3f} s"
        f"{' (built ' + ', '.join(built) + ')' if built else ''}, window "
        f"{seconds} s")
    window = offered.window(seconds=seconds)
    kept = list(window.batches)
    if trace_on:
        reading, breakdown, extra = _traced(cell, driver, mix, offered,
                                            log)
        kept += extra
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = bench.reader(m["name"]).read(reading)
            if value is None:
                log(f"bench: {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s" else
                     _end_to_end(bench, m["name"], window, setup.counts))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's outputs of the window against the plain
    # reference, once the peak is read (the program keeps no state beyond
    # the harness's weights and inputs, which the reference shares)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = setup.check(kept)
    limits = cell.workload["limits"]
    checks = {name: {"value": readings[name], "limit": limits[name]}
              for name in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and bool(kept)
    log(f"bench: check of {len(kept)} batches took "
        f"{time.perf_counter() - t_check:.3f} s")
    attempted = int(stats.total(window, setup.counts, "requests"))
    device_out = {**info, "memory_peak_bytes": int(peak)}
    if trace_on:
        device_out["busy_s"] = reading.busy_s
        device_out["window_s"] = reading.window_s
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_out}
    if trace_on:
        result["breakdown"] = breakdown
    result["setup"] = {"compiling_run": bool(built), "built": built}
    result["checks"] = checks      # last: the numbers compared and limits
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def _traced(cell, driver, mix, offered, log):
    """The device, gaps and layer windows (:mod:`benchkit.trace`)."""
    from torch.profiler import record_function
    sizes = cell.workload["trace"]
    runs = {}

    def windowed(key, count, spans):
        def go():
            if not spans:
                runs[key] = offered.window(count=count)
                return
            with record_function(trace.WINDOW_SPAN):
                runs[key] = offered.window(count=count,
                                           span=record_function)
                torch.cuda.synchronize()
        return go

    events, size = trace.profile_events(
        windowed("device", sizes["device_batches"], False), host=False)
    device = trace.device_time(events)
    window_s = runs["device"].seconds
    log(f"bench: device window {window_s:.4f} s, busy "
        f"{device['busy_s']:.4f} s, trace {size} bytes")
    del events
    events, size = trace.profile_events(
        windowed("gaps", sizes["gap_batches"], True), host=True)
    gaps = trace.idle_gaps(events)
    log(f"bench: gaps window trace {size} bytes")
    del events
    events, size = trace.profile_events(
        windowed("layer", sizes["layer_batches"], True), host=True,
        with_stack=True)
    by_stack = trace.attribute(events)
    del events
    total = sum(by_stack.values())
    log(f"bench: layer window trace {size} bytes, {len(by_stack)} stacks, "
        f"unattributed {by_stack.get(None, 0.0):.6f} of {total:.6f} s")
    reading = Reading(config=cell.config, traffic=mix, driver=driver,
                      window_s=window_s, busy_s=device["busy_s"],
                      batches=len(runs["device"].batches),
                      layer_batches=len(runs["layer"].batches),
                      by_stack=by_stack)
    breakdown = {"device_ops": device["device_ops"], "idle_gaps": gaps}
    return reading, breakdown, [b for key in ("device", "gaps", "layer")
                                for b in runs[key].batches]


def main(argv: list[str], t0: float, root: Path) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(Bench(root), args.workload, args.seed,
                          args.seconds, bool(args.trace), t0=t0)
    except NoCard as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    # after the window, in the process that prints the result: what the
    # port loaded, which no scan of the harness's sources would show
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
