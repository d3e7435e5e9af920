#!/usr/bin/env python3
"""``chip_smoke.py``'s ``examples`` phase alone, on one card.

    python3 scripts/examples_probe.py [--out DIR]

Builds K1, K3, K2, K4 and K5 (one ``nvcc`` each, started together; the
scripts load the built libraries), then runs every script of
``examples_torch/`` at its defaults, as ``python examples_torch/<name>.py``
in a process of its own, ``chip_smoke.EXAMPLE_LANES`` at a time, each
within ``chip_smoke.EXAMPLE_TIMEOUT`` seconds: a line per script with its exit
code, wall seconds, check and kernel launches, and the phase's seconds.
With ``--out`` each script's whole output is written to
``DIR/<name>.txt``.  Raises if a script fails, as ``chip_smoke.py`` does;
the card's name and power limit come first.

Needs a card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for each script's output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("examples_probe: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    errors = []

    def build(load):
        try:
            load()
        except BaseException as e:     # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(load,))
               for load in (cs.load_tiled_mm, cs.load_vpu_mm, cs.load_qmm,
                            cs.load_flash_attention, cs.load_ssd)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"set-up: tiled_mm, vpu_mm, qmm, flash_attention and ssd built "
          f"and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    examples = cs.phase_examples(card, args.out)
    print(json.dumps(examples))
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
