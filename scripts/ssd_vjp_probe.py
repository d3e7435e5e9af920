#!/usr/bin/env python3
"""K5's backward (``SSDFunction``: the VJP of ``ssd_chunked``) in three
precisions, on one card.

    python3 scripts/ssd_vjp_probe.py [--reps 10]

At zamba2-2.7b's training shape (B 2, L 1,024, H 80, N 64, chunk 128)
with P 64 (one card) and P 32 (a rank's share at 'model' 2), in fp32 and
bf16, runs the VJP that a train step's backward runs for one K5 call
(recompute y from the saved inputs, then ``torch.autograd.grad`` with a
random gradient of y) three ways:

- ``fp32 segments``: ``ssd_chunked`` as the forward runs it;
- ``float64 segments``: ``seg_dtype=torch.float64``, the segment sums of
  dta and their exps in float64 (what ``SSDFunction.backward`` runs);
- ``float64 whole``: every input cast to float64, the gradients cast back.

For each: the median ms of the VJP (CUDA events, the variants timed in
turns: a, b, c, c, b, a), the peak memory it allocates above its inputs
(``max_memory_allocated``), and in fp32 each gradient's largest error
over its largest entry against ``float64 whole``.  One JSON line per
case; the card and its power limit first.  Needs no kernel build and
imports nothing of JAX.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402

B, L, H, N, CHUNK = 2, 1024, 80, 64, 128
VARIANTS = ("fp32 segments", "float64 segments", "float64 whole")
INPUTS = ("xdt", "dta", "bm", "cm")


def make_inputs(p: int, dtype: torch.dtype, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    xdt = (0.5 * rnd(B, H, L, p)).to(dtype)
    # dt·a: softplus-sized steps times a negative decay rate
    dta = -torch.nn.functional.softplus(rnd(B, H, L)) * 0.1
    bm = (rnd(B, L, N) / N ** 0.5).to(dtype)
    cm = (rnd(B, L, N) / N ** 0.5).to(dtype)
    gy = rnd(B, H, L, p).to(dtype)
    return (xdt, dta.contiguous(), bm, cm), gy


def vjp(variant: str, inputs, gy):
    whole = variant == "float64 whole"
    seg = torch.float64 if variant != "fp32 segments" else torch.float32
    with torch.enable_grad():
        ins = [(t.to(torch.float64) if whole else t).detach()
               .requires_grad_(True) for t in inputs]
        y, _ = ssd_chunked(*ins, chunk=CHUNK, seg_dtype=seg)
        grads = torch.autograd.grad(y, ins, gy.to(y.dtype))
    return [g.to(t.dtype) for g, t in zip(grads, inputs)]


def timed(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_vjp_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps({"card": card[0] if card else "not read"}))
    for p in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            inputs, gy = make_inputs(p, dtype)
            runs = {v: (lambda v=v: vjp(v, inputs, gy)) for v in VARIANTS}
            for fn in runs.values():
                fn()                                    # warm-up
            peaks = {v: peak_bytes(fn) for v, fn in runs.items()}
            ms: dict = {v: [] for v in VARIANTS}
            for v in VARIANTS + VARIANTS[::-1]:
                ms[v].append(timed(runs[v], args.reps))
            line = {"shape": [B, L, H, p, N], "chunk": CHUNK,
                    "dtype": str(dtype).replace("torch.", ""),
                    "ms": ms, "peak_gb": {v: b / 1e9
                                          for v, b in peaks.items()}}
            if dtype == torch.float32:
                ref = runs["float64 whole"]()
                err = {}
                for v in VARIANTS[:2]:
                    got = runs[v]()
                    err[v] = {name: float((a - r).abs().max()
                                          / r.abs().max())
                              for name, a, r in zip(INPUTS, got, ref)}
                line["rel_err_vs_float64_whole"] = err
            print(json.dumps(line), flush=True)
            del inputs, gy, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
