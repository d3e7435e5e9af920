#!/usr/bin/env python3
"""What the runtime's NaN/Inf screen (``RetryPolicy.check_outputs``) costs
a panel on one card, for this checkout or another one.

    python3 scripts/screen_probe.py [--src DIR] [--reps N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two checkouts can be compared in turns, each run a process of its own
(parent, change, change, parent).  Builds K1 and K3 into that checkout's
``build/kernels``, then runs CIFAR_Alex+ at 256 frames (random weights
from seed 0) through ``SynergyRuntime(["cuda-tiled", "neon-vpu"])``: one
warm-up, then ``N`` forwards in each mode, the modes in turns per round:
no RetryPolicy (``none``), a RetryPolicy with the screen ``off``, and with
it ``on``.  Every forward must be the first one's bits.  Prints one JSON
line: per mode the host µs a panel (host clock around a synchronize,
over the forward's 10,768 panels) of every forward and their median, the
source directory, and the card's name and power limit.

Needs a card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("screen_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import PAPER_CNNS
    from repro_torch.core.synergy_mm import SynergyTrace
    from repro_torch.kernels.tiled_mm import load_tiled_mm
    from repro_torch.kernels.vpu_mm import load_vpu_mm
    from repro_torch.models.cnn import cnn_forward, init_cnn
    from repro_torch.soc import RetryPolicy, SynergyRuntime

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    load_tiled_mm()
    load_vpu_mm()
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = init_cnn(cfg, g)
    x = torch.randn(256, cfg.input_hw, cfg.input_hw, cfg.cin, generator=g)
    pool = ["cuda-tiled", "neon-vpu"]
    modes = {"none": None,
             "off": RetryPolicy(heartbeat_timeout_s=1.0,
                                monitor_interval_s=0.05),
             "on": RetryPolicy(check_outputs=True, heartbeat_timeout_s=1.0,
                               monitor_interval_s=0.05)}
    tr = SynergyTrace()
    with SynergyRuntime(pool, name="warm-up") as rt, tr.activate():
        want = cnn_forward(cfg, params, x, runtime=rt)
    torch.cuda.synchronize()
    panels = sum(js.grid[0] for js in tr.jobsets)
    us = {mode: [] for mode in modes}
    for _ in range(args.reps):
        for mode, retry in modes.items():
            with SynergyRuntime(pool, name=mode, retry=retry) as rt:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = cnn_forward(cfg, params, x, runtime=rt)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if not torch.equal(got, want):
                raise AssertionError(f"{mode}: logits differ from the "
                                     f"warm-up forward")
            us[mode].append(1e6 * wall / panels)
    print(json.dumps({
        "screen_probe": str(Path(args.src).resolve()), "panels": panels,
        "host_us_per_panel": us,
        "median": {m: statistics.median(v) for m, v in us.items()},
        "timer": "host clock around synchronize, one forward a sample, "
                 "modes in turns", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
