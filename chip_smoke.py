#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles the hand-written kernels from ``src/repro_torch``, one
   ``nvcc`` per source, all started together (set-up time, printed).
3. Kernels against their plain PyTorch versions, on the card, at every GEMM
   shape of CIFAR_Alex+ at 256 frames, at ragged shapes, for fp32 and bf16
   inputs and every fused epilogue.  TF32 is off for both matmul and cuDNN.
   ``vpu_mm`` is also checked at the runtime's 32-row panel shapes, bitwise
   against ``tiled_mm`` for every fp32 case, and its SASS must hold no
   tensor-core instruction.
4. Main path, dispatcher (slice 1): ``cnn_forward`` of CIFAR_Alex+ at its
   published widths on 256 frames, with launch counts set to 0 just before
   and read just after; logits are held against the same forward with
   every GEMM pinned to the plain fp32 oracle.  The other six paper CNNs
   run at 64 frames, held the same way.
   Main path, runtime (slice 2): the same forward through
   ``SynergyRuntime(["cuda-tiled", "neon-vpu"])``, every GEMM split into
   32-row panels over both kernels and balanced by stealing, counts set to
   0 just before and read just after; logits must be BITWISE equal to the
   dispatcher forward, both kernels must run panels, and launches must
   equal panels.  The other six CNNs run through it at 16 frames, bitwise.
5. Times (CUDA events, warm-up, median of 25): per Alex+ GEMM, each kernel,
   its plain version, ``torch.addmm`` + ReLU as the library yardstick, and
   the bound; both kernels also at the runtime's panel shapes, weighted by
   the panels each ran in phase 4's runtime forward; frames/s of the whole
   forward on both paths, and the runtime's host cost per panel; one
   runtime forward under ``torch.profiler``: each kernel's device time and
   the card's busy share.
6. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  A kernel's top-level numbers are the
   runtime path's (this slice's main path): launches in phase 4's runtime
   forward, and times of the panels it ran there; ``by_path`` gives each
   path's launches and times on its own basis.

Exits non-zero, with no result line, when no card is present or when run
outside a checkout of the repository.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
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
from repro_torch.kernels.common.build import sass_opcodes  # noqa: E402
from repro_torch.kernels.tiled_mm import (load_tiled_mm,  # noqa: E402
                                          tiled_matmul, tiled_mm_ref)
from repro_torch.kernels.vpu_mm import (load_vpu_mm,  # noqa: E402
                                        vpu_matmul, vpu_mm_library,
                                        vpu_mm_ref)
from repro_torch.models.cnn import cnn_forward, init_cnn  # noqa: E402
from repro_torch.soc import SynergyRuntime  # noqa: E402

DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on
#: the CUDA cores (no tensor cores, which is what the kernel uses) and HBM3
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_NOTE = "fp32 non-tensor 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"

FRAMES = 256
OTHER_FRAMES = 64
RUNTIME_OTHER_FRAMES = 16
REPS = 25
#: the runtime's pool on the card: the two hand-written kernels
POOL = ["cuda-tiled", "neon-vpu"]
#: CIFAR_Alex+ GEMMs at 256 frames: (name, m, n, k, fused ReLU)
ALEX_GEMMS = [("conv0", 262144, 64, 75, True), ("conv2", 65536, 64, 1600, True),
              ("conv4", 16384, 128, 1600, True), ("fc6", 256, 128, 2048, True),
              ("fc7", 256, 10, 128, False)]
#: the runtime's row panels of those GEMMs (TS = 32): (m, n, k)
PANELS = [(32, n, k) for _, _, n, k, _ in ALEX_GEMMS]
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


def phase_vpu_kernel() -> float:
    """Phase 3, K3: ``vpu_mm`` against its plain version at the runtime's
    panel shapes, the whole Alex+ GEMMs and the ragged shapes, and bitwise
    against ``tiled_mm`` for every fp32 case.  Returns the largest abs
    error over the main path's shapes (fp32, panels and whole GEMMs)."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    main_shapes = set(PANELS) | {(m, n, k) for _, m, n, k, _ in ALEX_GEMMS}
    shapes = PANELS + [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + RAGGED
    main_err, bitwise, bf16_bitwise = 0.0, 0, 0
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, device=DEVICE, generator=g).to(dtype)
            b = torch.randn(k, n, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(n, device=DEVICE, generator=g)
            tol = fp32_tol(k) if dtype == torch.float32 else BF16_TOL
            for act_name, act in acts.items():
                y = vpu_matmul(a, b, bias=bias, activation=act)
                r = vpu_mm_ref(a, b, bias=bias, activation=act)
                y1 = tiled_matmul(a, b, bias=bias, activation=act)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != (m, n):
                    raise AssertionError(f"vpu_mm {m}x{n}x{k} {dtype}: got "
                                         f"{y.dtype} {tuple(y.shape)}")
                torch.testing.assert_close(
                    y.float(), r.float(), rtol=tol, atol=tol,
                    msg=lambda s: f"vpu_mm {m}x{n}x{k} {dtype} "
                                  f"{act_name}: {s}")
                same = torch.equal(y, y1)
                if dtype == torch.float32:
                    if not same:
                        raise AssertionError(
                            f"vpu_mm {m}x{n}x{k} {act_name}: not bitwise "
                            f"equal to tiled_mm, max |diff| "
                            f"{(y - y1).abs().max().item():.3g}")
                    bitwise += 1
                    if (m, n, k) in main_shapes:
                        main_err = max(main_err,
                                       (y - r).abs().max().item())
                else:
                    bf16_bitwise += int(same)
    a = torch.randn(70, 33, device=DEVICE, generator=g).to(torch.bfloat16)
    b = torch.randn(33, 45, device=DEVICE, generator=g).to(torch.bfloat16)
    torch.testing.assert_close(vpu_matmul(a, b, out_dtype=torch.float32),
                               vpu_mm_ref(a, b, out_dtype=torch.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    a, b = a.float(), b.float()
    torch.testing.assert_close(vpu_matmul(a, b, activation=torch.tanh),
                               vpu_mm_ref(a, b, activation=torch.tanh),
                               rtol=fp32_tol(33), atol=fp32_tol(33))
    n_cases = len(shapes) * 6 + 2
    print(f"vpu_mm: {n_cases} cases agree with the plain version (fp32 tol "
          f"1e-5*sqrt(k), bf16 tol {BF16_TOL}); {bitwise} fp32 cases "
          f"bitwise equal to tiled_mm ({bf16_bitwise} of "
          f"{len(shapes) * 3} bf16 cases too)", flush=True)
    return main_err


def phase_sass() -> None:
    """Phase 3, K3: the built library runs CUDA-core FMAs and no
    tensor-core instruction (HMMA, HGMMA, IMMA, ...: any *MMA opcode)."""
    ops = sass_opcodes(vpu_mm_library())
    mma = sorted(op for op in ops if "MMA" in op)
    if mma:
        raise AssertionError(f"vpu_mm SASS holds tensor-core ops {mma}")
    if ops["FFMA"] == 0:
        raise AssertionError(f"vpu_mm SASS holds no FFMA: {dict(ops)}")
    print(f"vpu_mm SASS: {sum(ops.values())} instructions, {ops['FFMA']} "
          f"FFMA, no *MMA opcode; opcodes {sorted(ops)}", flush=True)


def phase_main_path() -> tuple:
    """Phase 4: the CNN forward through the dispatcher onto the kernel."""
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = init_cnn(cfg, g, device=DEVICE)
    x = torch.randn(FRAMES, cfg.input_hw, cfg.input_hw, cfg.cin, generator=g)

    tr = SynergyTrace()
    tiled_matmul.launches = 0
    vpu_matmul.launches = 0
    for e in list_engines():
        e.telemetry.reset()
    with tr.activate():
        logits = cnn_forward(cfg, params, x, device=DEVICE)
    torch.cuda.synchronize()
    launches, k3_launches = tiled_matmul.launches, vpu_matmul.launches
    torch_gemms = get_engine("torch").telemetry.gemms

    if launches != len(ALEX_GEMMS):
        raise AssertionError(f"tiled_mm launched {launches} times in the "
                             f"forward, expected {len(ALEX_GEMMS)}")
    if k3_launches != 0:
        raise AssertionError(f"vpu_mm launched {k3_launches} times in the "
                             f"dispatcher forward, expected 0")
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
    print(f"main path (dispatcher): {cfg.name} x{FRAMES} frames, tiled_mm "
          f"launches {launches}, vpu_mm launches {k3_launches}, "
          f"torch-engine GEMMs {torch_gemms}, "
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
    return cfg, params, x, {"tiled_mm": launches,
                            "vpu_mm": k3_launches}, logits


def phase_runtime_path(main: tuple) -> dict:
    """Phase 4, slice 2: the forward through the work-stealing runtime over
    both kernels, bitwise against the dispatcher forward of phase 4."""
    cfg, params, x, _, logits = main
    tr = SynergyTrace()
    with SynergyRuntime(POOL, name="cnn", device=DEVICE) as rt:
        for e in list_engines():
            e.telemetry.reset()
        rt.reset_stats()
        tiled_matmul.launches = 0
        vpu_matmul.launches = 0
        with tr.activate():
            got = cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
        torch.cuda.synchronize()
        k1, k3 = tiled_matmul.launches, vpu_matmul.launches
        stats = rt.stats()
    panels = sum(js.grid[0] for js in tr.jobsets)
    # panels each engine ran, per GEMM (a panel is one row of tile jobs)
    panels_by = {(js.m, js.n, js.k): {e: jobs // js.grid[1]
                                      for e, jobs in shares.items()}
                 for js, shares in tr.runtime_shares}
    ran = {e: sum(p.get(e, 0) for p in panels_by.values()) for e in POOL}
    per = stats["engines"]
    if set(per) != set(POOL):
        raise AssertionError(f"runtime pool {sorted(per)} != {POOL}")
    if not torch.equal(got, logits):
        raise AssertionError(
            f"runtime logits differ from the dispatcher forward: max |diff| "
            f"{(got - logits).abs().max().item():.3g}")
    if k1 == 0 or k3 == 0:
        raise AssertionError(f"a kernel ran no panel: tiled_mm {k1}, "
                             f"vpu_mm {k3}")
    if k1 + k3 != panels:
        raise AssertionError(f"launches {k1} + {k3} != {panels} panels")
    if ran != {"cuda-tiled": k1, "neon-vpu": k3}:
        raise AssertionError(f"runtime accounting {ran} != launches "
                             f"tiled_mm {k1}, vpu_mm {k3}")
    if stats["total_jobs"] != tr.num_jobs or stats["submissions"] != len(
            ALEX_GEMMS):
        raise AssertionError(f"runtime booked {stats['total_jobs']} tile "
                             f"jobs in {stats['submissions']} submissions, "
                             f"expected {tr.num_jobs} in {len(ALEX_GEMMS)}")
    others = {e.name: e.telemetry.jobs for e in list_engines()
              if e.name not in POOL and e.telemetry.jobs}
    if others or set(tr.engine_stats) - set(POOL):
        raise AssertionError(f"engines outside the pool ran work: {others} "
                             f"{sorted(tr.engine_stats)}")
    print(f"main path (runtime): {cfg.name} x{FRAMES} frames through "
          f"SynergyRuntime({POOL}): {panels} panels = tiled_mm {k1} + "
          f"vpu_mm {k3} launches, {stats['total_steals']} steals, logits "
          f"bitwise equal to the dispatcher forward", flush=True)
    for name in POOL:
        p = per[name]
        print(f"  {name}: {p['jobs']} tile jobs, {p['steals']} steals, "
              f"wall_busy_s {p['wall_busy_s']:.4f}, idle_s "
              f"{p['idle_s']:.4f}", flush=True)

    g = torch.Generator().manual_seed(3)
    with SynergyRuntime(POOL, name="others", device=DEVICE) as rt:
        for name, other in sorted(PAPER_CNNS.items()):
            if name == cfg.name:
                continue
            p = init_cnn(other, g, device=DEVICE)
            xo = torch.randn(RUNTIME_OTHER_FRAMES, other.input_hw,
                             other.input_hw, other.cin, generator=g)
            want = cnn_forward(other, p, xo, device=DEVICE)
            before = (tiled_matmul.launches, vpu_matmul.launches)
            y = cnn_forward(other, p, xo, runtime=rt, device=DEVICE)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"{name}: runtime logits differ from "
                                     f"the dispatcher forward")
            print(f"  {name} x{RUNTIME_OTHER_FRAMES}: bitwise equal, "
                  f"tiled_mm {tiled_matmul.launches - before[0]} + vpu_mm "
                  f"{vpu_matmul.launches - before[1]} panels", flush=True)
    return {"panels": panels, "tiled_mm": k1, "vpu_mm": k3,
            "panels_by": panels_by, "steals": stats["total_steals"],
            "engines": {n: {k: per[n][k] for k in ("jobs", "steals",
                                                   "wall_busy_s", "idle_s")}
                        for n in POOL}}


def phase_times(card: str, main: tuple) -> tuple[dict, float]:
    """Phase 5: per-GEMM times beside the bound, and frames/s.  Returns
    the K1 totals over one forward's GEMMs and the dispatcher forward's
    seconds."""
    cfg, params, x, *_ = main
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
    return totals, fwd["auto"]


def gemm_times(kernel, plain, m: int, n: int, k: int, relu: bool,
               g: torch.Generator) -> dict:
    """One GEMM shape: the kernel, its plain version and torch.addmm +
    ReLU (CUDA events, median of REPS), beside the bound."""
    a = torch.randn(m, k, device=DEVICE, generator=g)
    b = torch.randn(k, n, device=DEVICE, generator=g)
    bias = torch.randn(n, device=DEVICE, generator=g)
    act = torch.relu if relu else None

    def library():
        y = torch.addmm(bias, a, b)
        return torch.relu_(y) if relu else y

    bound_ms, bound_by = bound(m, n, k)
    return {"m": m, "n": n, "k": k,
            "ms": median_ms(lambda: kernel(a, b, bias=bias, activation=act)),
            "plain_ms": median_ms(lambda: plain(a, b, bias=bias,
                                                activation=act)),
            "library_ms": median_ms(library), "bound_ms": bound_ms,
            "bound_by": bound_by}


def add_times(totals: dict, t: dict, times: int = 1) -> None:
    """Add ``times`` calls of one timed shape to per-forward totals."""
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        totals[key] += times * t[key]
    totals["by_ops_ms" if t["bound_by"] == "operations"
           else "by_bytes_ms"] += times * t["bound_ms"]


def new_totals() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "by_ops_ms": 0.0, "by_bytes_ms": 0.0}


def phase_panel_times(card: str, run: dict) -> tuple[dict, dict]:
    """Phase 5, slice 2: both kernels at the runtime's panel shapes.  The
    per-forward totals weight each panel's times by the panels that kernel
    ran of that GEMM in phase 4's runtime forward.  Also ``vpu_mm`` per
    whole Alex+ GEMM, kept apart as a comparison with ``tiled_mm``'s
    whole GEMMs (the runtime never runs a whole GEMM)."""
    g = torch.Generator(device=DEVICE).manual_seed(4)
    kernels = {"tiled_mm": (tiled_matmul, tiled_mm_ref, "cuda-tiled"),
               "vpu_mm": (vpu_matmul, vpu_mm_ref, "neon-vpu")}
    runtime = {name: new_totals() for name in kernels}
    for (name, m, n, k, relu), panel in zip(ALEX_GEMMS, PANELS):
        shares = run["panels_by"][(m, n, k)]
        for kname, (kernel, plain, engine) in kernels.items():
            t = gemm_times(kernel, plain, *panel, relu, g)
            ran = shares.get(engine, 0)
            add_times(runtime[kname], t, ran)
            emit({"panel": f"CIFAR_Alex+/{name}", **t, "kernel": kname,
                  "panels_run": ran, "peak": PEAK_NOTE,
                  "library": "torch.addmm + relu_", "card": card})
    whole = new_totals()
    for name, m, n, k, relu in ALEX_GEMMS:
        t = gemm_times(vpu_matmul, vpu_mm_ref, m, n, k, relu, g)
        emit({"gemm": f"CIFAR_Alex+/{name}", **t, "kernel": "vpu_mm",
              "peak": PEAK_NOTE, "library": "torch.addmm + relu_",
              "tflops": 2e-9 * m * n * k / t["ms"], "card": card})
        add_times(whole, t)
    return runtime, whole


def runtime_forwards(cfg, params, x, pool: list, reps: int,
                     name: str = "timed") -> dict:
    """The runtime forward over ``pool``: host clock around synchronize,
    median of ``reps`` after 1 warm-up, whose trace gives the panels."""
    tr = SynergyTrace()
    with SynergyRuntime(pool, name=name, device=DEVICE) as rt:
        with tr.activate():
            cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
        rt.reset_stats()
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        stats = rt.stats()
    wall = statistics.median(samples)
    panels = sum(js.grid[0] for js in tr.jobsets)
    return {"pool": pool, "frames": len(x), "frames_per_s": len(x) / wall,
            "ms": 1e3 * wall, "panels": panels,
            "host_us_per_panel": 1e6 * wall / panels,
            "steals_per_forward": stats["total_steals"] / reps,
            "engines": {n: {k: stats["engines"][n][k] / reps
                            for k in ("jobs", "steals", "wall_busy_s",
                                      "idle_s")} for n in pool},
            "timer": f"host clock around synchronize, median of {reps} "
                     f"after 1 warm-up; engines: means over the {reps}"}


def phase_runtime_times(card: str, main: tuple, run: dict,
                        dispatcher_s: float) -> None:
    """Phase 5, slice 2: frames/s of the runtime forward (median of 5
    after 1 warm-up) beside the dispatcher forward of this run, and the
    host cost per panel."""
    cfg, params, x, *_ = main
    t = runtime_forwards(cfg, params, x, POOL, reps=5)
    if t["panels"] != run["panels"]:
        raise AssertionError(f"timed forward ran {t['panels']} panels, "
                             f"phase 4 {run['panels']}")
    emit({"forward": cfg.name, "path": "runtime", **t,
          "dispatcher_frames_per_s": FRAMES / dispatcher_s, "card": card})


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def phase_runtime_profile(card: str, main: tuple) -> dict:
    """Phase 5, slice 2: one runtime forward (after a warm-up one) under
    ``torch.profiler``: each kernel's device time and launches, and the
    share of the wall time in which at least one kernel ran on the card.
    Returns ``{kernel: {"count", "device_ms"}}``."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, x, *_ = main
    with SynergyRuntime(POOL, name="profiled", device=DEVICE) as rt:
        cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels, intervals = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ("tiled_mm" if "tiled_mm_kernel" in ev.name else
                "vpu_mm" if "vpu_mm_kernel" in ev.name else "other")
        k = kernels.setdefault(name, {"count": 0, "device_ms": 0.0})
        k["count"] += 1
        k["device_ms"] += (ev.time_range.end - ev.time_range.start) / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy_ms = union_us(intervals) / 1e3 if intervals else None
    emit({"profile": "one runtime forward, two-kernel pool",
          "wall_ms_under_profiler": 1e3 * wall, "kernels": kernels,
          "device_busy_ms": busy_ms,
          "device_busy_share": None if busy_ms is None
          else busy_ms / (1e3 * wall), "card": card})
    return kernels


def summary(t: dict) -> dict:
    """The kernels line's time keys from per-forward totals."""
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["by_ops_ms"] >= t["by_bytes_ms"]
                         else "bytes"),
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    # phase 1: device
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    errors = []

    def build(load):
        try:
            load()
        except BaseException as e:     # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(load,))
               for load in (load_tiled_mm, load_vpu_mm)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"set-up: tiled_mm and vpu_mm built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: kernels against their plain versions
    main_err = phase_kernels()
    vpu_err = phase_vpu_kernel()
    phase_sass()

    # phase 4: the main paths
    main = phase_main_path()
    run = phase_runtime_path(main)

    # phase 5: times
    totals, dispatcher_s = phase_times(card, main)
    runtime_totals, vpu_whole = phase_panel_times(card, run)
    phase_runtime_times(card, main, run, dispatcher_s)
    profiled = phase_runtime_profile(card, main)

    # phase 6: the kernels line, the card, the result
    on_runtime = (f"one CIFAR_Alex+ forward at {FRAMES} frames through the "
                  f"runtime: per-panel medians times the panels this kernel "
                  f"ran of each GEMM")
    whole = (f"one CIFAR_Alex+ forward at {FRAMES} frames: sum over its 5 "
             f"GEMMs, whole")
    sources = {"tiled_mm": ("src/repro_torch/kernels/tiled_mm/csrc/"
                            "tiled_mm.cu",
                            "src/repro/kernels/tiled_mm/tiled_mm.py:89",
                            main_err, totals),
               "vpu_mm": ("src/repro_torch/kernels/vpu_mm/csrc/vpu_mm.cu",
                          "src/repro/kernels/vpu_mm/vpu_mm.py:87",
                          vpu_err, None)}
    entries = []
    for name, (source, replaces, err, dispatcher) in sources.items():
        runtime = {"launches": run[name], **summary(runtime_totals[name]),
                   "per": on_runtime,
                   "profiled": {**profiled.get(name, {}), "per": (
                       "device time of another runtime forward under "
                       "torch.profiler")}}
        by_path = {"dispatcher": {"launches": main[3][name]},
                   "runtime": runtime}
        if dispatcher is not None:
            by_path["dispatcher"].update(summary(dispatcher), per=whole)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": run[name],
                 "max_abs_err": err, **summary(runtime_totals[name]),
                 "per": on_runtime, "by_path": by_path}
        if name == "vpu_mm":
            entry["whole_gemms"] = {**summary(vpu_whole), "per": (
                whole + "; a comparison with tiled_mm's whole GEMMs")}
        entries.append(entry)
    emit({"kernels": entries})
    print(f"card: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
