#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles the hand-written kernels from ``src/repro_torch`` (set-up
   time, printed).
3. Kernels against their plain PyTorch versions, on the card, at every GEMM
   shape of CIFAR_Alex+ at 256 frames, at ragged shapes, for fp32 and bf16
   inputs and every fused epilogue.  TF32 is off for both matmul and cuDNN.
4. Main path: ``cnn_forward`` of CIFAR_Alex+ at its published widths on 256
   frames, with launch counts set to 0 just before and read just after;
   logits are held against the same forward with every GEMM pinned to the
   plain fp32 oracle.  The other six paper CNNs run at 64 frames, held the
   same way.
5. Times (CUDA events, warm-up, median of 25): per Alex+ GEMM, the kernel,
   its plain version, ``torch.addmm`` + ReLU as the library yardstick, and
   the bound; frames/s of the whole forward.
6. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no card is present or when run
outside a checkout of the repository.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import PAPER_CNNS  # noqa: E402
from repro_torch.core.im2col import im2col  # noqa: E402
from repro_torch.core.synergy_mm import SynergyTrace  # noqa: E402
from repro_torch.engines import get_engine, list_engines  # noqa: E402
from repro_torch.kernels.tiled_mm import (load_tiled_mm,  # noqa: E402
                                          tiled_matmul, tiled_mm_ref)
from repro_torch.models.cnn import cnn_forward, init_cnn  # noqa: E402

DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on
#: the CUDA cores (no tensor cores, which is what the kernel uses) and HBM3
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_NOTE = "fp32 non-tensor 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"

FRAMES = 256
OTHER_FRAMES = 64
REPS = 25
#: CIFAR_Alex+ GEMMs at 256 frames: (name, m, n, k, fused ReLU)
ALEX_GEMMS = [("conv0", 262144, 64, 75, True), ("conv2", 65536, 64, 1600, True),
              ("conv4", 16384, 128, 1600, True), ("fc6", 256, 128, 2048, True),
              ("fc7", 256, 10, 128, False)]
RAGGED = [(70, 45, 33), (1, 257, 129), (130, 1, 31)]
LOGIT_TOL = 1e-4     # fp32 logits, five GEMMs summed in another order
BF16_TOL = 3e-2


def fp32_tol(k: int) -> float:
    """fp32 kernel vs plain: 1e-5 (the reference's own tolerance) scaled by
    sqrt(k), since the two sum k products in different orders."""
    return 1e-5 * max(1.0, math.sqrt(k))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
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


def bound(m: int, n: int, k: int, itemsize: int = 4) -> tuple[float, str]:
    """Least time in ms for act(A @ B + bias): each input read once and
    the output written once at the HBM rate, or the FMAs at the fp32 peak,
    whichever is larger."""
    t_ops = 2.0 * m * n * k / FP32_PEAK_FLOPS
    t_bytes = (itemsize * (m * k + k * n + m * n) + 4 * n) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> float:
    """Phase 3: the kernel against its plain version.  Returns the largest
    abs error over the main path's own GEMMs (fp32, their epilogues)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    main_err = 0.0
    shapes = [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + RAGGED
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, device=DEVICE, generator=g).to(dtype)
            b = torch.randn(k, n, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(n, device=DEVICE, generator=g)
            tol = fp32_tol(k) if dtype == torch.float32 else BF16_TOL
            for act_name, act in acts.items():
                y = tiled_matmul(a, b, bias=bias, activation=act)
                r = tiled_mm_ref(a, b, bias=bias, activation=act)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != (m, n):
                    raise AssertionError(f"{m}x{n}x{k} {dtype}: got "
                                         f"{y.dtype} {tuple(y.shape)}")
                torch.testing.assert_close(
                    y.float(), r.float(), rtol=tol, atol=tol,
                    msg=lambda s: f"{m}x{n}x{k} {dtype} {act_name}: {s}")
                err = (y.float() - r.float()).abs().max().item()
                main_gemm = (m, n, k) in {(gm, gn, gk)
                                          for _, gm, gn, gk, _ in ALEX_GEMMS}
                if main_gemm and dtype == torch.float32:
                    main_err = max(main_err, err)
    # bf16 in, fp32 out; an activation the kernel does not fuse
    a = torch.randn(70, 33, device=DEVICE, generator=g).to(torch.bfloat16)
    b = torch.randn(33, 45, device=DEVICE, generator=g).to(torch.bfloat16)
    y = tiled_matmul(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(y, tiled_mm_ref(a, b, out_dtype=torch.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    a, b = a.float(), b.float()
    torch.testing.assert_close(tiled_matmul(a, b, activation=torch.tanh),
                               tiled_mm_ref(a, b, activation=torch.tanh),
                               rtol=fp32_tol(33), atol=fp32_tol(33))
    # a row panel computed alone gives the same bits as the whole GEMM
    _, m, n, k, _ = ALEX_GEMMS[1]
    a = torch.randn(m, k, device=DEVICE, generator=g)
    b = torch.randn(k, n, device=DEVICE, generator=g)
    whole = tiled_matmul(a, b)
    panel = tiled_matmul(a[1000:3003].contiguous(), b)
    torch.cuda.synchronize()
    if not torch.equal(whole[1000:3003], panel):
        raise AssertionError("row panel differs from the whole GEMM")
    print(f"kernels: {len(shapes) * 6 + 3} cases agree with the plain "
          f"version (fp32 tol 1e-5*sqrt(k), bf16 tol {BF16_TOL}); "
          f"row panel bitwise equal", flush=True)
    return main_err


def phase_main_path() -> tuple:
    """Phase 4: the CNN forward through the dispatcher onto the kernel."""
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = init_cnn(cfg, g, device=DEVICE)
    x = torch.randn(FRAMES, cfg.input_hw, cfg.input_hw, cfg.cin, generator=g)

    tr = SynergyTrace()
    tiled_matmul.launches = 0
    for e in list_engines():
        e.telemetry.reset()
    with tr.activate():
        logits = cnn_forward(cfg, params, x, device=DEVICE)
    torch.cuda.synchronize()
    launches = tiled_matmul.launches
    torch_gemms = get_engine("torch").telemetry.gemms

    if launches != len(ALEX_GEMMS):
        raise AssertionError(f"tiled_mm launched {launches} times in the "
                             f"forward, expected {len(ALEX_GEMMS)}")
    if torch_gemms != 0:
        raise AssertionError(f"torch engine ran {torch_gemms} GEMMs")
    got = [(js.m, js.n, js.k) for js in tr.jobsets]
    want = [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS]
    if got != want:
        raise AssertionError(f"trace jobsets {got} != {want}")
    if set(tr.engine_stats) != {"cuda-tiled"}:
        raise AssertionError(f"GEMMs went to {sorted(tr.engine_stats)}")
    ref = cnn_forward(cfg, params, x, engine="reference", device=DEVICE)
    if logits.shape != (FRAMES, cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    torch.testing.assert_close(logits, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    err = (logits - ref).abs().max().item()
    print(f"main path: {cfg.name} x{FRAMES} frames, tiled_mm launches "
          f"{launches}, torch-engine GEMMs {torch_gemms}, "
          f"{len(tr.jobsets)} jobsets, logits max |err| vs reference "
          f"{err:.3g} (tol {LOGIT_TOL})", flush=True)

    for name, other in sorted(PAPER_CNNS.items()):
        if name == cfg.name:
            continue
        p = init_cnn(other, g, device=DEVICE)
        xo = torch.randn(OTHER_FRAMES, other.input_hw, other.input_hw,
                         other.cin, generator=g)
        n_gemm = sum(1 for s in other.layers if s[0] in ("conv", "fc"))
        before = tiled_matmul.launches
        y = cnn_forward(other, p, xo, device=DEVICE)
        yr = cnn_forward(other, p, xo, engine="reference", device=DEVICE)
        torch.cuda.synchronize()
        if tiled_matmul.launches - before != n_gemm:
            raise AssertionError(f"{name}: {tiled_matmul.launches - before}"
                                 f" launches, expected {n_gemm}")
        torch.testing.assert_close(y, yr, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        print(f"  {name} x{OTHER_FRAMES}: {n_gemm} launches, max |err| "
              f"{(y - yr).abs().max().item():.3g}", flush=True)
    return cfg, params, x, launches


def phase_times(card: str, main: tuple) -> dict:
    """Phase 5: per-GEMM times beside the bound, and frames/s."""
    cfg, params, x, _ = main
    g = torch.Generator(device=DEVICE).manual_seed(1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "by_ops_ms": 0.0, "by_bytes_ms": 0.0}
    for name, m, n, k, relu in ALEX_GEMMS:
        a = torch.randn(m, k, device=DEVICE, generator=g)
        b = torch.randn(k, n, device=DEVICE, generator=g)
        bias = torch.randn(n, device=DEVICE, generator=g)
        act = torch.relu if relu else None

        def library():
            y = torch.addmm(bias, a, b)
            return torch.relu_(y) if relu else y

        ms = median_ms(lambda: tiled_matmul(a, b, bias=bias, activation=act))
        plain_ms = median_ms(lambda: tiled_mm_ref(a, b, bias=bias,
                                                  activation=act))
        library_ms = median_ms(library)
        bound_ms, bound_by = bound(m, n, k)
        emit({"gemm": f"{cfg.name}/{name}", "m": m, "n": n, "k": k,
              "kernel": "tiled_mm", "ms": ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "peak": PEAK_NOTE, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "torch.addmm + relu_",
              "tflops": 2e-9 * m * n * k / ms, "card": card})
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["bound_ms"] += bound_ms
        totals["by_ops_ms" if bound_by == "operations"
               else "by_bytes_ms"] += bound_ms

    im2col_ms = 0.0
    for spec, h, w, c in cfg.trace_shapes()[0]:
        if spec[0] == "conv":
            _, _, kk, stride, pad = spec
            xi = torch.randn(FRAMES, h, w, c, device=DEVICE, generator=g)
            im2col_ms += median_ms(lambda: im2col(xi, kk, kk, stride, pad))

    def forward(engine=None):
        cnn_forward(cfg, params, x, engine=engine, device=DEVICE)

    fwd = {}
    for engine in (None, "reference"):
        for _ in range(3):
            forward(engine)
        samples = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(engine)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        fwd[engine or "auto"] = statistics.median(samples)
    emit({"forward": cfg.name, "frames": FRAMES,
          "frames_per_s": FRAMES / fwd["auto"], "ms": 1e3 * fwd["auto"],
          "tiled_mm_ms": totals["ms"], "im2col_ms": im2col_ms,
          "reference_pinned_frames_per_s": FRAMES / fwd["reference"],
          "timer": "host clock around synchronize, median of 20",
          "card": card})
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    # phase 1: device
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    load_tiled_mm()
    print(f"set-up: tiled_mm built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: kernels against their plain versions
    main_err = phase_kernels()

    # phase 4: the main path
    main = phase_main_path()

    # phase 5: times
    totals = phase_times(card, main)

    # phase 6: the kernels line, the card, the result
    emit({"kernels": [{
        "name": "tiled_mm", "route": "cuda",
        "source": "src/repro_torch/kernels/tiled_mm/csrc/tiled_mm.cu",
        "replaces": "src/repro/kernels/tiled_mm/tiled_mm.py:89",
        "launches": main[3], "max_abs_err": main_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations"
                     if totals["by_ops_ms"] >= totals["by_bytes_ms"]
                     else "bytes"),
        "library_ms": totals["library_ms"],
        "per": "one CIFAR_Alex+ forward at 256 frames: sum over its 5 GEMMs",
    }]})
    print(f"card: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
