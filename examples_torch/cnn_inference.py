"""The paper end-to-end on the card: CIFAR CNN inference through the
Synergy stack — im2col + tiled-MM jobs + layer-threaded pipeline — plus
the DES reproduction of Fig 9 / Fig 13 / Table 6 numbers.

The auto-dispatched forward runs its GEMMs on the hand-written fp32 tile
kernel (``tiled_mm``, K1) on the card; the pipeline pins its stage to the
``torch`` engine (``torch.matmul``, ``repro``'s ``xla``); the runtime
splits one frame across the paper's simulated PEs.  On the card the
script ends by running the same weights and frame on the CPU, where every
kernel is its plain version, and holds the card's logits against it.

    PYTHONPATH=src python examples_torch/cnn_inference.py [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.paper_cnns import PAPER_CNNS  # noqa: E402
from repro_torch.core.pipeline import (EngineStage,  # noqa: E402
                                       ThreadedPipeline)
from repro_torch.core.scheduler import (search_sc, simulate,  # noqa: E402
                                        single_thread_latency)
from repro_torch.core.synergy_mm import SynergyTrace  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.models.cnn import (build_simnet, cnn_forward,  # noqa: E402
                                    init_cnn)
from repro_torch.soc import SynergyRuntime  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

NET = "CIFAR_full"
#: the card's logits against the CPU's and the runtime's against the
#: dispatcher's, absolute (fp32; GEMMs summed in another order)
LOGIT_TOL = 1e-4


def default_inputs(dev) -> tuple:
    """The net's parameters and one (1, H, W, C) frame, drawn on ``dev``
    from generators seeded 0 and 1."""
    cfg = PAPER_CNNS[NET]
    params = init_cnn(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    x = torch.randn((1, cfg.input_hw, cfg.input_hw, cfg.cin), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    return params, x


def run(device="cuda", *, params: dict | None = None,
        x: torch.Tensor | None = None, frames: int = 16,
        des_frames: int = 96, sc_frames: int = 64) -> dict:
    """One traced frame, a pipelined stream of ``frames``, one frame split
    across the PE pool, and the DES.  ``params`` (on ``device``) and ``x``
    (1, H, W, C) default to :func:`default_inputs`.  Returns every
    printed figure."""
    dev = resolve_device(device)
    cfg = PAPER_CNNS[NET]
    if params is None or x is None:
        params, x = default_inputs(dev)
    shape = (1, cfg.input_hw, cfg.input_hw, cfg.cin)
    x = x.to(dev)

    # --- job decomposition of one frame ------------------------------------
    tr = SynergyTrace()
    with tr.activate():
        logits = cnn_forward(cfg, params, x, device=dev)
    on_k1 = launch_counts()["tiled_mm"]

    # --- inter-frame pipeline over engine-backed stages --------------------
    g = torch.Generator(device=dev).manual_seed(2)
    stream = [torch.randn(shape, generator=g, device=dev)
              for _ in range(frames)]
    stages = [EngineStage("infer", lambda f: cnn_forward(
                  cfg, params, f, engine="torch", device=dev),
                  engine="torch"),
              ("postproc", lambda lg: int(torch.argmax(lg)))]
    _, pstats = ThreadedPipeline(stages).run(stream)

    # --- LIVE work stealing: one frame split across the PE pool -------------
    with SynergyRuntime(["F-PE", "S-PE", "NEON"], name="cnn",
                        device=dev) as rt:
        logits_rt = cnn_forward(cfg, params, x, runtime=rt, device=dev)
        st = rt.stats()

    # --- the paper's runtime, reproduced ------------------------------------
    net = build_simnet(cfg)
    single = single_thread_latency(net)
    ws = simulate(net, policy="ws", frames=des_frames)
    sf = simulate(net, policy="sf", frames=des_frames)
    _, _, sc = search_sc(net, frames=sc_frames)
    return {
        "device": device_label(dev), "on_card": dev.type == "cuda",
        "net": cfg.name,
        "logits": logits.cpu(), "logits_shape": tuple(logits.shape),
        "gemms": len(tr.jobsets), "tile_jobs": tr.num_jobs,
        "jobsets": [(js.name, js.m, js.n, js.k, js.num_jobs,
                     js.padding_waste) for js in tr.jobsets],
        "dispatched": {name: (t.gemms, t.jobs, t.busy_s)
                       for name, t in tr.engine_stats.items()},
        "forward_tiled_mm_launches": on_k1,
        "pipeline_fps": pstats["fps"],
        "stage_utilization": pstats["stage_utilization"],
        "runtime_engines": list(st["engines"]),
        "runtime_jobs": st["total_jobs"], "runtime_steals": st["total_steals"],
        "runtime_busy_fraction": st["aggregate_busy_fraction"],
        "drift": float(torch.max(torch.abs(logits_rt - logits))),
        "single_thread_s": single,
        "ws_fps": ws.fps, "ws_utilization": ws.utilization,
        "sf_fps": sf.fps, "sf_utilization": sf.utilization,
        "sc_fps": sc.fps, "sc_utilization": sc.utilization,
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, x = default_inputs(dev)
    host = tree_map(lambda t: t.to("cpu", copy=True),
                    {"params": params, "x": x})
    out = run(dev, params=params, x=x)
    print(f"{out['net']}: logits {out['logits_shape']}, {out['gemms']} GEMMs "
          f"-> {out['tile_jobs']} tile jobs (TS=32), on {out['device']}")
    for name, m, n, k, jobs, waste in out["jobsets"]:
        print(f"  {name:<22s} m={m:<5d} n={n:<4d} k={k:<5d} "
              f"jobs={jobs:<3d} pad_waste={waste:5.1%}")
    for name, (gemms, jobs, busy_s) in out["dispatched"].items():
        print(f"  dispatched to {name}: {gemms} GEMMs / {jobs} jobs "
              f"(~{busy_s * 1e3:.2f} ms est busy)")
    print(f"  tiled_mm (K1) launches in the forward: "
          f"{out['forward_tiled_mm_launches']}")
    print(f"\npipelined inference: {out['pipeline_fps']:.1f} frames/s on "
          f"{out['device']}, stage util {out['stage_utilization']}")
    print(f"\nruntime split across {out['runtime_engines']}: "
          f"{out['runtime_jobs']} tile jobs, {out['runtime_steals']} stolen, "
          f"agg busy fraction {out['runtime_busy_fraction']:.2f} "
          f"(|logits drift| {out['drift']:.2e})")
    ws, sf, sc = out["ws_fps"], out["sf_fps"], out["sc_fps"]
    print("\nZynq runtime simulation (calibrated DES; the paper's figures):")
    print(f"  single-thread ARM: {out['single_thread_s'] * 1e3:7.1f} ms/frame")
    print(f"  Synergy (WS):      {ws:7.1f} fps "
          f"(speedup {ws * out['single_thread_s']:.1f}x, "
          f"util {out['ws_utilization']:.1%})")
    print(f"  static fixed (SF): {sf:7.1f} fps "
          f"(util {out['sf_utilization']:.1%})")
    print(f"  static custom(SC): {sc:7.1f} fps "
          f"(util {out['sc_utilization']:.1%})")
    print(f"  WS vs SF: +{100 * (ws / sf - 1):.0f}%   "
          f"WS vs SC: +{100 * (ws / sc - 1):.0f}%   (paper: +24% / +6%)")

    failures = []
    if not torch.isfinite(out["logits"]).all():
        failures.append("the logits are not finite")
    if out["on_card"] and out["forward_tiled_mm_launches"] != out["gemms"]:
        failures.append(f"{out['forward_tiled_mm_launches']} K1 launches "
                        f"for {out['gemms']} GEMMs")
    if out["drift"] > LOGIT_TOL:
        failures.append(f"the runtime's logits drift {out['drift']:.2e} "
                        f"> {LOGIT_TOL:g} from the dispatcher's")
    if dev.type == "cuda":
        ref = run("cpu", **host)
        err = float(torch.max(torch.abs(out["logits"] - ref["logits"])))
        print(f"the same weights and frame on the CPU (plain versions): "
              f"|logits diff| {err:.2e} (tol {LOGIT_TOL:g})")
        if not err <= LOGIT_TOL:
            failures.append(f"the card's logits are {err:.2e} from the "
                            f"CPU's, past {LOGIT_TOL:g}")
    print(json.dumps({"example": "cnn_inference",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
