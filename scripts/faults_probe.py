#!/usr/bin/env python3
"""``chip_smoke.py``'s ``faults`` phase alone, on one card, with what it
needs of the phases before it.

    python3 scripts/faults_probe.py

Builds K1, K3 and K2 (one ``nvcc`` each, started together), then runs
phase 4's CIFAR_Alex+ x256 forwards (the dispatcher's, the runtime's over
``["cuda-tiled", "neon-vpu"]`` and the int8 decode paths, which calibrate
``cuda-tiled-int8``), the dense serving check (the fault-free tokens), the
runtime forward's frames/s (median of 3 after 1 warm-up), and
``phase_faults``: the chaos forward, the NaN/Inf screen off and on, int8
under faults, serving over a faulted pool, retry exhaustion and the
slowdown quarantine.  Each phase raises on failure, as in
``chip_smoke.py``; the card's name and power limit come first.  About a
minute of a card once the kernels are built.

Needs a card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("faults_probe: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errors = []

    def build(load):
        try:
            load()
        except BaseException as e:     # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(load,))
               for load in (cs.load_tiled_mm, cs.load_vpu_mm, cs.load_qmm)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"set-up: tiled_mm, vpu_mm and qmm built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    main_path = cs.phase_main_path()
    run = cs.phase_runtime_path(main_path)
    decode = cs.phase_decode_paths(main_path)
    serving = {"dense": cs.phase_serving_dense()}
    cfg, params, x, *_ = main_path
    runtime_fp32 = cs.runtime_forwards(cfg, params, x, cs.POOL, reps=3)
    print(f"runtime forward: {runtime_fp32['frames_per_s']:.2f} frames/s, "
          f"{runtime_fp32['host_us_per_panel']:.1f} host us a panel",
          flush=True)
    cs.phase_faults(card, main_path, run, decode, serving, runtime_fp32)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
