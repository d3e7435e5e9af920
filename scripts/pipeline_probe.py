#!/usr/bin/env python3
"""What holds the inter-frame pipeline back on one card: the runs that
``chip_smoke.py``'s ``pipeline`` phase does not make.

    python3 scripts/pipeline_probe.py

Runs CIFAR_Alex+ at 256 frames (random weights from a seed) as 8
micro-batches of 32 through ``chip_smoke.py``'s three stages (K1, K3, K1)
and prints one JSON line per measurement (host clock around synchronize,
median of 5 after 1 warm-up):

1. ``mode``, in the turns ``pipeline``, ``serial``, ``dispatcher``,
   ``pipeline``: the ``ThreadedPipeline`` as ``chip_smoke.py`` runs it;
   the same stage functions one after another on one thread, per
   micro-batch; and ``cnn_forward`` whole.  Every mode's logits must be
   the dispatcher forward's bits.
2. ``profile``: one pipeline run under ``torch.profiler``, with the
   card's busy share.
3. ``path`` ``pipeline`` and ``graph``: K1's and K3's GEMMs on those
   paths, each timed (CUDA events, median of ``chip_smoke.REPS``) in the
   kernel, in its plain version (``tiled_mm_ref`` / ``vpu_mm_ref``,
   float64 sums) and in ``torch.addmm`` + ReLU on the same operands,
   beside the bound (``chip_smoke.bound``: each input read once and the
   output written once at the HBM rate, or the products at the fp32
   peak, whichever is longer).  The pipeline: each stage's GEMMs at a
   micro-batch of 32 frames (K1: conv0, conv4, fc6, fc7; K3: conv2),
   times the 8 micro-batches.  The graph: the conv front-end's 32-row
   panels (conv0, conv2, conv4), times the panels of all 8 waves
   (10,752), for each kernel as if it ran them all (which kernel takes a
   panel is the runtime's choice at run time).

Needs a card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import (MICRO, ThreadedPipeline, emit,  # noqa: E402
                        host_timed, pipeline_stages, profiled_run)

FRAMES = 256
REPS = 5


def gemm_paths(card: str) -> None:
    """3. K1's and K3's GEMMs of the pipeline's stages and of the graph's
    panels: kernel, plain version, ``torch.addmm`` + ReLU and the bound."""
    g = torch.Generator(device="cuda").manual_seed(5)
    micro = FRAMES // MICRO
    kernels = {"cuda-tiled": ("tiled_mm", chip_smoke.tiled_matmul,
                              chip_smoke.tiled_mm_ref),
               "neon-vpu": ("vpu_mm", chip_smoke.vpu_matmul,
                            chip_smoke.vpu_mm_ref)}
    stage_of = {layer: engine for _, lo, hi, engine in
                chip_smoke.PIPE_STAGES for layer in range(lo, hi)}
    pipe = {name: chip_smoke.new_totals() for name, _, _ in
            kernels.values()}
    graph = {name: chip_smoke.new_totals() for name, _, _ in
             kernels.values()}
    launches = {name: 0 for name in pipe}
    rows, panels = chip_smoke.PANELS[0][0], 0     # the runtime's panels
    for gemm, m, n, k, relu in chip_smoke.ALEX_GEMMS:
        name, kernel, plain = kernels[stage_of[int(gemm[-1])]]
        t = chip_smoke.gemm_times(kernel, plain, m // micro, n, k, relu, g)
        chip_smoke.add_times(pipe[name], t, micro)
        launches[name] += micro
        emit({"path": "pipeline", "gemm": f"CIFAR_Alex+/{gemm}", **t,
              "kernel": name, "calls": micro, "card": card})
        if not gemm.startswith("conv"):
            continue
        count = m // rows
        panels += count
        for name, kernel, plain in kernels.values():
            t = chip_smoke.gemm_times(kernel, plain, rows, n, k,
                                      relu, g)
            chip_smoke.add_times(graph[name], t, count)
            emit({"path": "graph", "panel": f"CIFAR_Alex+/{gemm}", **t,
                  "kernel": name, "panels": count, "card": card})
    for name in pipe:
        emit({"path": "pipeline", "kernel": name, "launches": launches[name],
              **chip_smoke.summary(pipe[name]),
              "per": f"one run of {FRAMES} frames as {micro} micro-batches",
              "library": "torch.addmm + relu_", "card": card})
        emit({"path": "graph", "kernel": name, "panels": panels,
              **chip_smoke.summary(graph[name]),
              "per": f"all {panels} panels of {micro} waves, as if this "
                     f"kernel ran every one",
              "library": "torch.addmm + relu_", "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke.PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = chip_smoke.init_cnn(cfg, g, device="cuda")
    x = torch.randn(FRAMES, cfg.input_hw, cfg.input_hw, cfg.cin,
                    generator=g).to("cuda")
    want = chip_smoke.cnn_forward(cfg, params, x, device="cuda")
    frames = list(x.split(MICRO))

    def pipeline():
        return ThreadedPipeline(pipeline_stages(cfg, params)).run(frames)

    def serial():
        stages = pipeline_stages(cfg, params)
        outs = []
        for mb in frames:
            for st in stages:
                with chip_smoke.engine_scope(st.engine):
                    mb = st(mb)
            outs.append(mb)
        return outs, None

    def dispatcher():
        return chip_smoke.cnn_forward(cfg, params, x, device="cuda")

    def report(mode: str, fn) -> None:
        samples, runs = host_timed(fn, REPS)
        got = torch.cat(runs[0][0]) if mode != "dispatcher" else runs[0]
        if not torch.equal(got, want):
            raise AssertionError(f"{mode}: logits differ from the "
                                 f"dispatcher forward")
        wall = statistics.median(samples)
        emit({"mode": mode, "frames": FRAMES, "micro_batches": len(frames),
              "frames_per_s": FRAMES / wall, "ms": 1e3 * wall,
              "timer": f"host clock around synchronize, median of {REPS} "
                       f"after 1 warm-up", "card": card})

    for mode, fn in (("pipeline", pipeline), ("serial", serial),
                     ("dispatcher", dispatcher), ("pipeline", pipeline)):
        report(mode, fn)
    gemm_paths(card)
    pipeline()
    kernels, busy_ms, wall = profiled_run(pipeline)
    emit({"profile": "one pipeline run", "kernels": kernels,
          "wall_ms_under_profiler": 1e3 * wall,
          "device_busy_ms": busy_ms,
          "device_busy_share": None if busy_ms is None
          else busy_ms / (1e3 * wall), "card": card})
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
