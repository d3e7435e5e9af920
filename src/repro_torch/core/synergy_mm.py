"""``synergy_mm`` — the composable tiled-MM operator (paper C1/C2).

Every dense GEMM in the framework is routed through :func:`synergy_matmul`.
It does three things:

  1. Registers the GEMM's :class:`~repro_torch.core.job.JobSet` with the
     active :class:`SynergyTrace` (the job decomposition the schedulers,
     cost model, and roofline analysis operate on).
  2. Executes: under an active :func:`repro_torch.soc.runtime_scope` the
     JobSet's tile jobs are SPLIT into row panels across the live engine
     pool and merged (work stealing balances the split; an ``engine=`` pin
     is demoted to a queue-affinity hint).  Otherwise it asks the
     :class:`~repro_torch.engines.Dispatcher` for the best-capable
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

from repro_torch.device import ranked_device
from repro_torch.engines import (CAP_GRAD, Engine, Telemetry,
                                 current_scope_engine, dispatch_gemm)
from repro_torch.soc.runtime import current_runtime, is_concrete

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
    #: one (JobSet, {engine: tile jobs it executed}) per runtime GEMM
    runtime_shares: list[tuple[JobSet, dict[str, int]]] = dataclasses.field(
        default_factory=list)
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

    def record_runtime(self, js: JobSet, accounting: dict) -> None:
        """Book a SynergyRuntime submission's per-engine shares: the split
        GEMM's jobs land on every engine that actually executed part of it
        (stolen jobs included), on the same cost-model busy basis.  The
        gemm itself counts ONCE, credited to the dominant executor, so
        ``sum(gemms) == len(jobsets)`` holds on both dispatch paths."""
        self.runtime_shares.append(
            (js, {name: acct["jobs"] for name, acct in accounting.items()}))
        dominant = (max(accounting, key=lambda n: accounting[n]["jobs"])
                    if accounting else None)
        for name, acct in accounting.items():
            t = self.engine_stats.setdefault(name, Telemetry())
            t.record_jobs(acct["jobs"], acct["est_s"], acct["bytes"],
                          gemms=int(name == dominant),
                          steals=acct["steals"])

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
    applying the precision-routing policy.  Under a runtime scope the GEMM
    is split across the runtime's pool, unless autograd records it: the
    pool's kernels have no backward, so a differentiated GEMM keeps
    single-engine dispatch onto a grad-safe engine.
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

    rt = current_runtime()
    if rt is not None and not require and is_concrete(a, b, bias):
        # precision routing under a runtime scope happens INSIDE the
        # split (per-job int8 eligibility + LPT over the pool); only an
        # explicit engine pin survives, as a queue-affinity hint
        affinity = engine.name if isinstance(engine, Engine) else engine
        y, accounting = rt.run_matmul(
            js, a.reshape(-1, k), b, bias=bias, activation=activation,
            tile=tile if isinstance(tile, tuple) else (tile,) * 3,
            out_dtype=out_dtype, affinity=affinity, job_class=job_class)
        if tr is not None:
            tr.record_runtime(js, accounting)
        return y.reshape(*lead, m, n)

    device = ranked_device(a.device)
    eng = dispatch_gemm(js, engine=engine, require=require,
                        job_class=job_class, device=device)
    est_s = eng.estimate(js, device)
    eng.telemetry.record(js, est_s)
    if tr is not None:
        tr.record_engine(eng.name, js, est_s)

    a2 = a.reshape(-1, k)
    y = eng.execute(a2, b, bias=bias, activation=activation, tile=tile,
                    out_dtype=out_dtype)
    return y.reshape(*lead, m, n)
