"""The heterogeneous precision zoo on the card: fp32 + int8 + VPU engines
on one chip.

Walks the whole quant subsystem end to end:

  1. calibrate + register an int8 engine over the ``torch`` backend
     (``repro``'s ``xla``) — the gate measures the TRUE int8×int8 path,
     the hand-written int8 kernel (``qmm``, K2) on the card, and swaps the
     nominal 4x cost guess for the rate measured there (and the registry
     still REFUSES an engine that misses tolerance);
  2. the online activation-calibration lifecycle: a fresh engine starts
     on the weight-only fp32-cast GEMM, the first live batch publishes a
     per-shape ActScale, and from then on the contraction consumes int8
     operands;
  3. precision routing: decode-class GEMMs land on the int8 engine,
     prefill/train stay on grad-safe full-precision paths, and plain
     auto-dispatch never silently quantizes;
  4. serving: a SynergyServer whose decode steps run quantized AND feed
     the calibrator, with per-precision job counts in ServeStats;
  5. the throughput claim: a mixed fp32+int8+VPU pool beats the best
     homogeneous pool on busy-fraction-weighted simulated fps, while the
     int8 outputs stay inside the calibrated tolerance of the fp32 oracle;
  6. the VPU engine is real compute: ``vpu_mm`` (K3, CUDA cores) against
     the oracle.

    PYTHONPATH=src python examples_torch/quant_zoo.py [--device cpu]
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.job import JobSet  # noqa: E402
from repro_torch.core.serving import Request, SynergyServer  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.engines import (Dispatcher, get_engine,  # noqa: E402
                                 unregister_engine)
from repro_torch.engines.sim import (SIM_ENGINE_SPECS,  # noqa: E402
                                     SimPEEngine)
from repro_torch.engines.vpu import NeonVpuEngine  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.kernels.qmm import qmm_matmul  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.quant import (DEFAULT_SHAPES,  # noqa: E402
                               CalibrationError, QuantizedEngine,
                               calibrate, register_quantized, rel_err)
from repro_torch.soc import SimRuntime  # noqa: E402

SERVE_CFG = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=32,
                    n_heads=2, d_ff=64, vocab=128)


#: the H100 SXM data sheet's int8 dense tensor-core rate and HBM rate:
#: the least time the card could take for K2's work
INT8_OPS_PER_S, HBM_BYTES_PER_S = 1979e12, 3.35e12


def _randn(g, dev, *shape, scale=1.0):
    return torch.randn(shape, generator=g, device=dev) * scale


def k2_alone(dev, reps: int = 50) -> dict:
    """K2 (``qmm_matmul``, fused dequant) alone on the card at the
    calibration's largest shape: the median of ``reps`` calls timed with
    CUDA events, its rate, and its bound (each operand read once and the
    fp32 output written once at HBM rate, or the int8 products at the
    tensor cores' peak, whichever is longer)."""
    m, k, n = DEFAULT_SHAPES[-1]
    g = torch.Generator(device=dev).manual_seed(4)
    a_q = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                        dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=dev) * 0.01
    for _ in range(3):
        qmm_matmul(a_q, w_q, scale)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        qmm_matmul(a_q, w_q, scale)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    moved = m * k + k * n + 4 * n + 4 * m * n
    bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S,
                         2 * m * n * k / INT8_OPS_PER_S)
    return {"shape": (m, k, n), "reps": reps, "ms": ms,
            "gmacs": m * n * k / ms / 1e6, "bound_ms": bound_ms}


def run(device="cuda", *, params: dict | None = None,
        prompts: list | None = None, operands: dict | None = None,
        pool_frames: int = 16) -> dict:
    """The six steps; returns every printed figure.  ``params`` (on
    ``device``) are the serving model's, ``prompts`` its three requests'
    tokens, ``operands`` the (a, w) pairs of the lifecycle (``"life"``)
    and accuracy (``"acc"``) steps; each defaults to draws from seeded
    generators."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(3)
    if operands is None:
        operands = {"life": (_randn(g, dev, 4, 64),
                             _randn(g, dev, 64, 128, scale=0.05)),
                    "acc": (_randn(g, dev, 4, 64),
                            _randn(g, dev, 64, 256, scale=0.05))}
    operands = {k: tuple(torch.as_tensor(t).to(dev) for t in v)
                for k, v in operands.items()}
    out = {"device": device_label(dev), "on_card": dev.type == "cuda"}

    # --- 1. calibrated registration --------------------------------------
    before = launch_counts()["qmm"]
    eng = register_quantized("torch", tol=0.05, device=dev)
    try:
        out["registered"] = eng.name
        out["calibration"] = str(eng.calibration)
        out["int8_path"] = eng.calibration.int8_path
        out["calibration_qmm_launches"] = launch_counts()["qmm"] - before
        out["measured_gmacs"] = eng.cost_on(dev).macs_per_s / 1e9
        out["nominal_speedup"] = eng.speedup
        out["k2_alone"] = k2_alone(dev) if out["on_card"] else None
        try:
            register_quantized("torch", name="impossible-int8", tol=1e-9,
                               device=dev)
            out["refused"] = None
        except CalibrationError as e:
            out["refused"] = (f"{type(e).__name__}: "
                              f"{str(e).split(':')[0]} ...")

        # --- 2. the online activation-calibration lifecycle --------------
        fresh = QuantizedEngine(get_engine("torch"), name="lifecycle-int8")
        a, w = operands["life"]
        out["scale_before"] = fresh.act_scale_for(64, 128)
        y = fresh.execute(a, w)              # first decode batch observes
        out["scale_after"] = fresh.act_scale_for(64, 128)
        out["lifecycle_rel_err"] = rel_err(
            y, get_engine("reference").execute(a, w))

        # --- 3. precision routing ----------------------------------------
        js = JobSet.for_gemm(0, 8, 256, 64, 32, name="decode-step")
        d = Dispatcher()
        out["routing"] = {str(cls): d.select(js, job_class=cls,
                                             device=dev).name
                          for cls in (None, "decode", "prefill", "train")}

        # --- 4. serving with quantized decode ----------------------------
        if params is None:
            params = init_model(SERVE_CFG, 0, device=dev)
        if prompts is None:            # host tokens, as a server takes them
            prompts = [torch.randint(
                0, 128, (4,), dtype=torch.int32,
                generator=torch.Generator().manual_seed(i)) for i in range(3)]
        srv = SynergyServer(SERVE_CFG, params, slots=2, max_len=32,
                            prefill_len=4, device=dev)
        for i, p in enumerate(prompts):
            srv.submit(Request(i, torch.as_tensor(p, dtype=torch.int32),
                               max_new_tokens=6))
        stats = srv.run()
        out["served_routes"] = dict(stats.job_engine)
        out["precision_jobs"] = dict(stats.precision_jobs)
    finally:
        unregister_engine(eng.name)

    # --- 5. mixed pool vs best homogeneous pool --------------------------
    fp32 = SimPEEngine("zoo-fp32", SIM_ENGINE_SPECS["F-PE"])
    int8 = QuantizedEngine(fp32, name="zoo-int8")
    vpu = NeonVpuEngine("zoo-vpu", cost=SIM_ENGINE_SPECS["NEON"])
    report = calibrate(int8, tol=0.05, device=dev)
    frames = [JobSet.for_gemm(i, 128, 256, 64, 32, name=f"decode{i}")
              for i in range(pool_frames)]

    def run_pool(engines):
        makespan, fracs = 0.0, 0.0
        for fjs in frames:
            res = SimRuntime(engines).run(fjs)
            makespan += res.makespan_s
            fracs += res.aggregate_busy_fraction
        fps = len(frames) / makespan
        return fps, fps * fracs / len(frames)

    out["pools"] = {name: run_pool(p) for name, p in [
        ("fp32-only", [fp32]), ("int8-only", [int8]), ("vpu-only", [vpu]),
        ("mixed", [fp32, int8, vpu])]}
    best = max(v[1] for k, v in out["pools"].items() if k != "mixed")
    out["gain"] = out["pools"]["mixed"][1] / best
    # the accuracy side of the trade: int8 decode output vs fp32 oracle,
    # measured with the same formula the calibration gate uses
    a, w = operands["acc"]
    out["int8_rel_err"] = rel_err(int8.execute(a, w), fp32.execute(a, w))
    out["tol"] = report.tol

    # --- 6. the VPU kernel is real compute --------------------------------
    before = launch_counts()["vpu_mm"]
    y = get_engine("neon-vpu").execute(a, w, tile=(16, 16, 16))
    out["vpu_mm_launches"] = launch_counts()["vpu_mm"] - before
    out["vpu_matches"] = bool(torch.allclose(
        y, get_engine("reference").execute(a, w), rtol=1e-4, atol=1e-4))
    out["launches"] = launch_counts()
    return out


def banner(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    banner(f"calibrate + register (gated on the int8x8 path), "
           f"{out['device']}")
    print(f"registered {out['registered']!r}: {out['calibration']}")
    if out["int8_path"] and out["calibration_qmm_launches"]:
        print(f"  cost model: {out['measured_gmacs']:.2f} GMAC/s, the "
              f"calibration's host-timed rate through the qmm kernel (K2, "
              f"{out['calibration_qmm_launches']} launches on "
              f"{out['device']}; each call's quantization and a "
              f"synchronize included; drops the nominal "
              f"{out['nominal_speedup']:g}x guess)")
    else:
        path = "int8x8 plain version" if out["int8_path"] else "weight-only"
        print(f"  cost model: measured {out['measured_gmacs']:.2f} GMAC/s "
              f"on the {path} path on {out['device']} (qmm not launched; "
              f"drops the nominal {out['nominal_speedup']:g}x guess)")
    if out["k2_alone"]:
        k2 = out["k2_alone"]
        print("  K2 alone at m={} k={} n={}: {:.2f} GMAC/s ({:.2f} us a "
              "qmm_matmul call between CUDA events, its launch path "
              "included; median of {}); its bound {:.3f} us (int8 dense "
              "1,979 TOP/s, HBM 3.35 TB/s: the H100 SXM data sheet)".format(
                  *k2["shape"], k2["gmacs"], 1e3 * k2["ms"], k2["reps"],
                  1e3 * k2["bound_ms"]))
    if out["refused"]:
        print(f"refused past tolerance: {out['refused']}")

    banner("activation calibration: weight-only -> int8x8")
    print(f"  before any live batch: act scale = {out['scale_before']} "
          f"(weight-only fp32-cast GEMM)")
    print(f"  after one decode batch: act scale = {out['scale_after']:.5f} "
          f"-> int8 operands into the contraction")
    print(f"  int8x8 rel err vs oracle: {out['lifecycle_rel_err']:.2e}")

    banner("job-class routing")
    for cls, name in out["routing"].items():
        print(f"  job_class={cls:<8} -> {name}")

    banner("SynergyServer: quantized decode steps")
    print(f"  routed: {out['served_routes']}")
    print(f"  per-precision tile jobs: {out['precision_jobs']}")

    banner("mixed fp32+int8+VPU pool (virtual time)")
    for name, (fps, wfps) in out["pools"].items():
        print(f"  {name:<10} {fps:7.1f} fps  "
              f"{wfps:7.1f} busy-fraction-weighted fps")
    print(f"  mixed pool vs best homogeneous: {out['gain']:.2f}x "
          f"({'WINS' if out['gain'] > 1 else 'loses'})")
    within = out["int8_rel_err"] <= out["tol"]
    print(f"  int8 decode rel err vs fp32 oracle: {out['int8_rel_err']:.2e} "
          f"(calibrated tol {out['tol']:g}) -> "
          f"{'within tolerance' if within else 'OUT OF TOLERANCE'}")

    banner("NeonVpuEngine: vpu_mm (K3, CUDA cores)" if out["on_card"] else
           "NeonVpuEngine: vpu_mm's plain version (CPU)")
    print(f"  vpu_mm matches oracle: {out['vpu_matches']} "
          f"({out['vpu_mm_launches']} launches)")

    failures = []
    if out["gain"] <= 1.0:
        failures.append(f"the mixed pool loses ({out['gain']:.2f}x)")
    if not within:
        failures.append("int8 decode is out of tolerance")
    if not out["vpu_matches"]:
        failures.append("vpu_mm disagrees with the oracle")
    if out["refused"] is None:
        failures.append("an engine past tolerance was registered")
    if out["on_card"] and not (out["int8_path"]
                               and out["calibration_qmm_launches"]
                               and out["vpu_mm_launches"]):
        failures.append("the card did not run qmm (K2) and vpu_mm (K3)")
    print(json.dumps({"example": "quant_zoo",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
