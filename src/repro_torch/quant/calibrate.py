"""Calibration: measure a quantized engine's error against the fp32 oracle
and refuse registration past tolerance (``repro.quant.calibrate``,
ported).

Before an int8 engine may enter the registry, it must show, per GEMM
shape, that its output stays within a relative tolerance of the fp32
reference.  The :class:`CalibrationReport` travels with the engine
(``engine.calibration``).

The sweep runs on a device (the card by default).  Its inputs come from a
seeded ``torch.Generator`` on the CPU, so its rows are not ``repro``'s
(``jax.random`` cannot be replayed); the gate and the ``rel_err`` formula
are the same.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.engines.base import CAP_SIM, CostModel, Engine
from repro_torch.engines.registry import get_engine, register_engine

from .engine import INT8_SPEEDUP, QuantizedEngine

__all__ = ["CalibrationError", "CalibrationReport", "DEFAULT_SHAPES",
           "DEFAULT_TOL", "calibrate", "register_quantized", "rel_err"]

#: (m, k, n) GEMM shapes spanning the serving mix: tiny memory-bound
#: decode steps up to prefill/CNN-sized panels (border shapes included)
DEFAULT_SHAPES: tuple[tuple[int, int, int], ...] = (
    (1, 64, 64),       # single-token decode
    (4, 128, 256),     # batched decode
    (33, 70, 45),      # border tiles in every dimension
    (128, 256, 128),   # prefill / conv panel
)

#: default max relative error vs the fp32 oracle
DEFAULT_TOL = 0.05


class CalibrationError(ValueError):
    """Raised when a quantized engine exceeds the error tolerance."""


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Quant-error metadata: per-shape relative error vs the fp32 oracle,
    plus the rate measured on the engine's real compute path."""

    engine: str
    base: str
    tol: float
    rows: tuple[dict, ...]            # {"m", "k", "n", "rel_err", "wall_s"}
    max_rel_err: float
    #: MACs/s measured over the sweep's timed pass (None when too fast to
    #: time) — what replaces the nominal 4x
    measured_macs_per_s: float | None = None
    #: whether the timed pass ran the int8×int8 kernel
    int8_path: bool = False

    @property
    def passed(self) -> bool:
        return self.max_rel_err <= self.tol

    def __str__(self) -> str:
        worst = max(self.rows, key=lambda r: r["rel_err"])
        return (f"CalibrationReport({self.engine}: max_rel_err="
                f"{self.max_rel_err:.2e} @ {worst['m']}x{worst['k']}x"
                f"{worst['n']}, tol={self.tol:g}, "
                f"{'int8x8' if self.int8_path else 'weight-only'}, "
                f"{'PASS' if self.passed else 'FAIL'})")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max relative error vs a reference — the ONE formula the calibration
    gate and the acceptance checks measure with."""
    got32 = got.to(torch.float32)
    want32 = want.to(torch.float32)
    denom = float(want32.abs().max()) + 1e-12
    return float((got32 - want32).abs().max()) / denom


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(engine: Engine, *, shapes=DEFAULT_SHAPES,
              tol: float = DEFAULT_TOL, seed: int = 0,
              device: str | torch.device | None = None) -> CalibrationReport:
    """Run ``engine`` over random GEMMs of each shape on ``device`` (the
    card by default) and compare against the fp32 oracle.  Pure
    measurement — registration gating happens in
    :func:`register_quantized`.

    For a :class:`QuantizedEngine` with an activation calibrator, the
    untimed warm passes per shape feed the calibrator its seeded batch, so
    the error rows AND the timed rate measure the engine as it will serve:
    through the int8×int8 kernel.  The warm passes also absorb the
    kernel's build, so ``measured_macs_per_s`` is a steady-state rate."""
    from repro_torch.kernels.tiled_mm.ref import tiled_mm_ref
    dev = resolve_device(device)
    rows = []
    total_macs, total_wall = 0, 0.0
    # enough warm passes to cross the calibrator's publish threshold (and
    # build the kernel) before the timed pass; re-observing the same batch
    # keeps the EMA at that batch's max|a|, to rounding
    cal = getattr(engine, "calibrator", None)
    warm_passes = max(1, cal.min_updates) if cal is not None else 1
    gen = torch.Generator().manual_seed(seed)
    for m, k, n in shapes:
        a = torch.randn(m, k, generator=gen).to(dev)
        w = (torch.randn(k, n, generator=gen) * 0.05).to(dev)
        want = tiled_mm_ref(a, w)
        for _ in range(warm_passes):
            engine.execute(a, w, tile=(32, 32, 32))
        _sync(dev)
        t0 = time.perf_counter()
        got = engine.execute(a, w, tile=(32, 32, 32))
        _sync(dev)
        wall = time.perf_counter() - t0
        total_macs += m * k * n
        total_wall += wall
        rows.append({"m": m, "k": k, "n": n, "rel_err": rel_err(got, want),
                     "wall_s": wall})
    report = CalibrationReport(
        engine=engine.name,
        base=getattr(getattr(engine, "base", None), "name", engine.name),
        tol=tol, rows=tuple(rows),
        max_rel_err=max(r["rel_err"] for r in rows),
        measured_macs_per_s=(total_macs / total_wall
                             if total_wall > 1e-9 else None),
        int8_path=bool(getattr(engine, "act_scale_for", lambda k, n: None)(
            shapes[-1][1], shapes[-1][2]) is not None))
    if isinstance(engine, QuantizedEngine) or hasattr(engine, "calibration"):
        engine.calibration = report
    return report


def register_quantized(base: Engine | str, *,
                       name: str | None = None,
                       speedup: float = INT8_SPEEDUP,
                       cost: CostModel | None = None,
                       shapes=DEFAULT_SHAPES, tol: float = DEFAULT_TOL,
                       seed: int = 0,
                       measure_rate: bool = True,
                       override: bool = False,
                       device: str | torch.device | None = None
                       ) -> QuantizedEngine:
    """Wrap ``base`` as an int8 engine, calibrate it on ``device`` (the
    card by default), and register it — REFUSING registration if the
    measured error exceeds ``tol``.

        eng = register_quantized("cuda-tiled")  # 'cuda-tiled-int8' joins

    Unless ``measure_rate`` is False or ``cost`` was passed, the engine's
    cost model drops the nominal ``speedup``x guess for the rate measured
    on that device during the sweep.  CAP_SIM bases keep their scaled
    paper constants.  ``unregister_engine(eng.name)`` retires it."""
    if isinstance(base, str):
        base = get_engine(base)
    dev = resolve_device(device)
    eng = QuantizedEngine(base, name=name, speedup=speedup, cost=cost)
    report = calibrate(eng, shapes=shapes, tol=tol, seed=seed, device=dev)
    if not report.passed:
        raise CalibrationError(
            f"refusing to register {eng.name!r}: max relative error "
            f"{report.max_rel_err:.3e} exceeds tolerance {tol:g} ({report})")
    if (measure_rate and cost is None
            and report.measured_macs_per_s is not None
            and CAP_SIM not in base.capabilities):
        eng.recalibrate(report.measured_macs_per_s, alpha=1.0, device=dev)
    return register_engine(eng, override=override)
