#!/usr/bin/env python3
"""K2's two staging paths on the same shapes, on one card.

    python3 scripts/qmm_path_probe.py

``qmm`` takes its ``async`` path (16-byte ``cp.async``) when k and n are
multiples of 16 and A and W start on 16-byte boundaries, and its
``shift`` path (4-byte copies realigned by a funnel shift) otherwise.  To
time ``shift`` on the shapes that take ``async`` on the main path, the
same operands are copied to addresses 4 bytes past a 16-byte boundary:
their rows then start on 4-byte boundaries, so ``shift`` does the same
work it would do on aligned rows (every shift is 0).

For conv2, conv4 and fc6 of CIFAR_Alex+ at 256 frames (the dispatcher's
fused fp32 GEMMs) and their 32-row panels (the runtime's raw int32 mode),
in rounds ordered async, shift, shift, async, prints one JSON line per
shape: per path, the CUDA-event median of ``qmm_matmul`` (what
``chip_smoke.py`` reports; it holds the wrapper's host time) and the
device time per launch under ``torch.profiler``, and the shift/async
ratio of each.  The two paths' outputs are held bitwise equal.  Needs a
card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import ALEX_GEMMS, DEVICE, emit, median_ms, rand_int8  # noqa: E402
from repro_torch.kernels.qmm import qmm_matmul  # noqa: E402
from repro_torch.kernels.qmm.qmm import qmm_path  # noqa: E402

SHAPES = ("conv2", "conv4", "fc6")
PANEL_ROWS = 32
REPS = 50
PROFILED = 100
ORDER = ("async", "shift", "shift", "async")


def off_boundary(t: torch.Tensor) -> torch.Tensor:
    """A copy of contiguous int8 ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=torch.int8, device=t.device)
    skip = (4 - buf.data_ptr()) % 16
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def device_us(fn) -> float:
    """Device time of one call of ``fn``, in µs: the mean over PROFILED
    calls of the qmm kernels' durations under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.time_range.end - ev.time_range.start
                for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and chip_smoke.kernel_name(ev.name) == "qmm")
    return total / PROFILED


def probe(label: str, m: int, n: int, k: int, relu: bool, fused: bool,
          g: torch.Generator) -> dict:
    a, w = rand_int8(g, m, k), rand_int8(g, k, n)
    w_scale = torch.rand(1, n, device=DEVICE, generator=g) * 1e-3
    bias = torch.randn(n, device=DEVICE, generator=g)
    operands = {"async": (a, w), "shift": (off_boundary(a), off_boundary(w))}

    def call(path):
        a_, w_ = operands[path]
        if fused:
            return qmm_matmul(a_, w_, w_scale, act_scale=0.02, bias=bias,
                              activation=torch.relu if relu else None)
        return qmm_matmul(a_, w_, w_scale, fuse_dequant=False)

    for path, (a_, w_) in operands.items():
        got = qmm_path(a_.data_ptr(), w_.data_ptr(), n, k)
        if got != path:
            raise AssertionError(f"{label}: operands meant for {path} take "
                                 f"{got}")
    if not torch.equal(call("async"), call("shift")):
        raise AssertionError(f"{label}: the two paths differ")
    event = {p: [] for p in operands}
    device = {p: [] for p in operands}
    for path in ORDER:
        event[path].append(median_ms(lambda: call(path), reps=REPS))
        device[path].append(device_us(lambda: call(path)))
    row = {"shape": label, "m": m, "n": n, "k": k,
           "mode": "fused" if fused else "raw"}
    for path in operands:
        row[f"{path}_event_ms"] = event[path]
        row[f"{path}_device_us"] = device[path]
    row["shift_over_async_event"] = (statistics.median(event["shift"])
                                     / statistics.median(event["async"]))
    row["shift_over_async_device"] = (statistics.median(device["shift"])
                                      / statistics.median(device["async"]))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("qmm_path_probe: no CUDA device is available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for name, m, n, k, relu in ALEX_GEMMS:
        if name not in SHAPES:
            continue
        emit({**probe(f"CIFAR_Alex+/{name}", m, n, k, relu, True, g),
              "card": card})
        emit({**probe(f"CIFAR_Alex+/{name} panel", PANEL_ROWS, n, k, relu,
                      False, g), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
