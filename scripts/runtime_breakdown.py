#!/usr/bin/env python3
"""Where the time of the runtime path goes, on one card: the runs that
``chip_smoke.py`` does not make.

    python3 scripts/runtime_breakdown.py

Runs CIFAR_Alex+ at 256 frames through ``SynergyRuntime`` (random weights
from a seed) with ``chip_smoke.runtime_forwards`` (host clock around
synchronize, median of 3 after 1 warm-up; panels from the warm-up's
trace) and prints one JSON line per measurement:

1. ``pool``: frames/s and host µs per panel for the two-kernel pool and for
   each kernel alone (one worker thread, so no contention between workers).
2. ``switchinterval_s``: the two-kernel pool with the interpreter's thread
   switch interval at its default and at 1/50 of it.

The device time of each kernel and the card's busy share come from
``chip_smoke.py``'s profiled runtime forward.  Needs a card; exits
non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import POOL, emit, runtime_forwards  # noqa: E402

FRAMES = 256
REPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("runtime_breakdown: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke.PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = chip_smoke.init_cnn(cfg, g, device="cuda")
    x = torch.randn(FRAMES, cfg.input_hw, cfg.input_hw, cfg.cin, generator=g)

    for pool in (POOL, POOL[:1], POOL[1:]):
        emit({**runtime_forwards(cfg, params, x, pool, REPS, "breakdown"),
              "card": card})

    default = sys.getswitchinterval()
    for interval in (default, default / 50):
        sys.setswitchinterval(interval)
        try:
            t = runtime_forwards(cfg, params, x, POOL, REPS, "breakdown")
        finally:
            sys.setswitchinterval(default)
        emit({"switchinterval_s": interval, **{
            k: t[k] for k in ("frames_per_s", "host_us_per_panel", "panels")},
            "card": card})
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
