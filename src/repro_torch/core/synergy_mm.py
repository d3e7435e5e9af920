"""``synergy_mm`` — the composable tiled-MM operator (paper C1/C2).

Every dense GEMM in the framework is routed through :func:`synergy_matmul`.
It does three things:

  1. Registers the GEMM's :class:`~repro_torch.core.job.JobSet` with the
     active :class:`SynergyTrace` (the job decomposition the schedulers,
     cost model, and roofline analysis operate on).
  2. Asks the :class:`~repro_torch.engines.Dispatcher` for the best-capable
     registered :class:`~repro_torch.engines.Engine` for operands on the
     device they live on (the CUDA ``tiled_mm`` kernel for CUDA tensors,
     ``torch.matmul`` for CPU tensors, or whatever the user registered)
     and runs the whole GEMM there.
  3. Records per-engine telemetry (jobs, estimated busy seconds, bytes
     moved) on both the engine and the active trace.

The job abstraction is exactly the paper's: one job == one output tile of C,
zero-padded at borders so a single fixed-size engine serves every layer of
every network ("network-agnostic accelerators").  PyTorch runs eagerly, so
counters advance once per executed GEMM.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional, Union

import torch

from repro_torch.engines import (CAP_GRAD, Engine, Telemetry,
                                 current_scope_engine, dispatch_gemm)

from .job import JobSet

__all__ = ["SynergyTrace", "synergy_matmul", "current_trace", "DEFAULT_TILE"]

DEFAULT_TILE = (256, 256, 256)

_state = threading.local()


@dataclasses.dataclass
class SynergyTrace:
    """Collects the JobSets of every GEMM run under this context, plus the
    per-engine telemetry of where the dispatcher routed them."""

    jobsets: list[JobSet] = dataclasses.field(default_factory=list)
    engine_stats: dict[str, Telemetry] = dataclasses.field(
        default_factory=dict)
    _next_layer_id: int = 0

    def add(self, m: int, n: int, k: int, tile, name: str) -> JobSet:
        js = JobSet.for_gemm(self._next_layer_id, m, n, k, tile, name=name)
        self._next_layer_id += 1
        self.jobsets.append(js)
        return js

    def record_engine(self, engine_name: str, js: JobSet,
                      est_s: float) -> None:
        self.engine_stats.setdefault(engine_name, Telemetry()).record(js,
                                                                      est_s)

    @property
    def total_flops(self) -> int:
        return sum(js.total_flops for js in self.jobsets)

    @property
    def num_jobs(self) -> int:
        return sum(js.num_jobs for js in self.jobsets)

    @contextlib.contextmanager
    def activate(self):
        prev = getattr(_state, "trace", None)
        _state.trace = self
        try:
            yield self
        finally:
            _state.trace = prev


def current_trace() -> Optional[SynergyTrace]:
    return getattr(_state, "trace", None)


def _under_grad(*tensors) -> bool:
    """True when autograd will record this GEMM: grad mode is on and an
    operand requires grad.  The dispatch-level guard that keeps
    CAP_GRAD-free engines (the CUDA tile kernel has no backward) off
    differentiated GEMMs even when no call site asked for grad-safety."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def synergy_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   bias: torch.Tensor | None = None,
                   activation: Callable | None = None,
                   tile: tuple[int, int, int] | int = DEFAULT_TILE,
                   name: str = "",
                   engine: Union[str, Engine, None] = None,
                   job_class: str | None = None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = act(A @ B + bias) through the Synergy tile-job abstraction.

    a: (..., m, k); b: (k, n).  ``engine``: a registered engine name (or
    instance); None lets the dispatcher rank capable engines by their cost
    model on the operands' device.  ``job_class``: one of
    :data:`repro_torch.engines.JOB_CLASSES` ("decode", "prefill", "train")
    applying the precision-routing policy.
    """
    *lead, m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if engine is None:
        engine = current_scope_engine()   # engine_scope() pin, if any

    # grad guard: a GEMM being differentiated may only land on CAP_GRAD
    # engines, whatever the job class said (a grad-free pin under autograd
    # is a hard error, not a silently missing gradient).
    require = (CAP_GRAD,) if _under_grad(a, b, bias) else ()

    batch = 1
    for d in lead:
        batch *= d
    tr = current_trace()
    if tr is not None:
        js = tr.add(batch * m, n, k, tile, name=name or "gemm")
    else:
        js = JobSet.for_gemm(0, batch * m, n, k, tile, name=name or "gemm")

    eng = dispatch_gemm(js, engine=engine, require=require,
                        job_class=job_class, device=a.device)
    est_s = eng.estimate(js, a.device)
    eng.telemetry.record(js, est_s)
    if tr is not None:
        tr.record_engine(eng.name, js, est_s)

    a2 = a.reshape(-1, k)
    y = eng.execute(a2, b, bias=bias, activation=activation, tile=tile,
                    out_dtype=out_dtype)
    return y.reshape(*lead, m, n)
