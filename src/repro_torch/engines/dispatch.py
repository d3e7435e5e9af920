"""The Dispatcher: route each GEMM's JobSet to the best-capable engine.

The dispatch rule is the paper's scheduling insight at engine granularity:
filter by capability, rank by the shared cost model, run on the winner.
``synergy_matmul`` consults the default dispatcher for every dense GEMM in
the framework, so registering a faster engine reroutes all work with zero
call-site edits.  Ranking keys on the device the GEMM's operands live on
(``synergy_matmul`` passes it down): the same engine pool ranks one way for
CUDA tensors and another for CPU tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterable, Iterator, Optional, Union

from repro_torch.obs import trace as _trace

from .base import CAP_GEMM, CAP_GRAD, CAP_INT8, CAP_SIM, Engine
from .registry import get_engine, list_engines

__all__ = ["Dispatcher", "DEFAULT_DISPATCHER", "dispatch_gemm",
           "engine_scope", "current_scope_engine",
           "JobClassPolicy", "JOB_CLASSES"]

_scope = threading.local()


@contextlib.contextmanager
def engine_scope(engine: Union[str, Engine, None]) -> Iterator[None]:
    """Pin every auto-dispatched GEMM in this thread to ``engine`` for the
    duration of the block.  ``None`` restores dispatcher auto-selection;
    scopes nest."""
    prev = getattr(_scope, "engine", None)
    _scope.engine = engine
    try:
        yield
    finally:
        _scope.engine = prev


def current_scope_engine() -> Union[str, Engine, None]:
    return getattr(_scope, "engine", None)


@dataclasses.dataclass(frozen=True)
class JobClassPolicy:
    """Precision-routing policy for one job class.

    ``require``: hard capability filter (candidates lacking any are out).
    ``prefer``:  soft filter — if any candidate advertises every preferred
    capability, selection ranks only those; otherwise it falls back to the
    full candidate set (a pool with no int8 engine still serves decode).
    """

    require: frozenset = frozenset()
    prefer: frozenset = frozenset()


#: the precision-routing table (paper §3 job classes, serving-era names):
#: decode steps are small, memory-bound and error-tolerant — trade
#: precision for rate when an int8 engine is registered.  Prefill feeds
#: the KV cache every later token reads, and training differentiates the
#: GEMM, so both are pinned to grad-safe full-precision paths.  NOTE:
#: CAP_GRAD is a deliberately conservative full-precision proxy — it also
#: keeps prefill off grad-FREE fp32 kernels (the CUDA tile engine);
#: deployments that trust those for prefill can relax the table
#: (JOB_CLASSES["prefill"] is plain data, not policy machinery).
JOB_CLASSES: dict[str, JobClassPolicy] = {
    "decode": JobClassPolicy(prefer=frozenset({CAP_INT8})),
    # the serving load-shed ladder's degraded tier: sheddable tenants'
    # decode REQUIRES an int8 engine, freeing the fp32 pool for
    # interactive traffic
    "decode_degraded": JobClassPolicy(require=frozenset({CAP_INT8}),
                                      prefer=frozenset({CAP_INT8})),
    "prefill": JobClassPolicy(require=frozenset({CAP_GRAD})),
    "train": JobClassPolicy(require=frozenset({CAP_GRAD})),
}


class Dispatcher:
    """Capability-filtered, cost-ranked engine selection.

    ``require``: capabilities every candidate must advertise.
    ``exclude``: capabilities that disqualify a candidate from AUTO
    selection — simulated PEs (they model a 0.1 GMAC/s Zynq fabric and
    would never win, but excluding them keeps auto-dispatch semantics
    independent of what simulators are registered) and int8 quantized
    engines (their cost models beat fp32 peers, so cost ranking alone
    would silently trade away precision process-wide; a job class that
    prefers or requires ``int8`` lifts the exclusion, and an explicit
    ``engine=`` pin bypasses it entirely).
    """

    def __init__(self, require: Iterable[str] = (CAP_GEMM,),
                 exclude: Iterable[str] = (CAP_SIM, CAP_INT8)):
        self.require = frozenset(require)
        self.exclude = frozenset(exclude)

    def candidates(self, require: Iterable[str] = (),
                   exclude: Optional[frozenset] = None) -> list[Engine]:
        req = self.require | frozenset(require)
        exc = self.exclude if exclude is None else exclude
        return [e for e in list_engines()
                if e.supports(req) and not (e.capabilities & exc)
                and e.available()]

    def select(self, jobset, *, engine: Union[str, Engine, None] = None,
               require: Iterable[str] = (),
               job_class: Optional[str] = None,
               device=None) -> Engine:
        """Pick the engine for one JobSet whose operands live on ``device``.

        An explicit ``engine`` (name or instance) bypasses ranking but is
        still capability-checked; otherwise the cheapest capable candidate
        by its cost-model estimate on ``device`` wins.  ``job_class``
        applies the precision routing policy in :data:`JOB_CLASSES`: its
        ``require`` set becomes a hard filter (checked even against an
        explicit engine), and its ``prefer`` set narrows auto-selection
        when any candidate offers it (decode prefers ``int8``;
        prefill/train require ``grad``)."""
        if job_class is None:
            policy = _NO_POLICY
        else:
            try:
                policy = JOB_CLASSES[job_class]
            except KeyError:
                raise KeyError(
                    f"unknown job class {job_class!r}; known: "
                    f"{sorted(JOB_CLASSES)}") from None
        req = self.require | frozenset(require) | policy.require
        if engine is not None:
            eng = get_engine(engine) if isinstance(engine, str) else engine
            if not eng.supports(req):
                missing = sorted(req - eng.capabilities)
                raise ValueError(f"engine {eng.name!r} lacks required "
                                 f"capabilities {missing}")
            return eng
        # a capability the caller/policy asks for cannot also disqualify
        exc = self.exclude - policy.prefer - req
        cands = self.candidates(req - self.require, exclude=exc)
        if not cands:
            raise RuntimeError(
                f"no registered engine satisfies capabilities {sorted(req)}")
        if policy.prefer:
            preferred = [e for e in cands if policy.prefer <= e.capabilities]
            if preferred:
                cands = preferred
        eng = min(cands, key=lambda e: e.estimate(jobset, device))
        # one module-attribute check: dispatch decisions show up on traces
        # (process-default tracer only; tracing off = no-op)
        if _trace._default is not None:
            _trace._default.emit(
                "dispatch", eng.name, jobset=getattr(jobset, "name", None),
                job_class=job_class, n_candidates=len(cands))
        return eng


_NO_POLICY = JobClassPolicy()

DEFAULT_DISPATCHER = Dispatcher()


def dispatch_gemm(jobset, *, engine: Union[str, Engine, None] = None,
                  require: Iterable[str] = (),
                  job_class: Optional[str] = None,
                  device=None) -> Engine:
    """Module-level shorthand for ``DEFAULT_DISPATCHER.select``."""
    return DEFAULT_DISPATCHER.select(jobset, engine=engine, require=require,
                                     job_class=job_class, device=device)
