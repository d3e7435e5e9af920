"""repro_torch.soc.faults — deterministic fault injection for engine pools.

Synergy's runtime (§3.1.3, §4.3) adapts to workload imbalance but the
paper assumes every accelerator invocation returns a correct result.  On
real embedded SoCs — thermal throttling, failed accelerator calls,
transient compute errors — that assumption fails routinely, and a runtime
that cannot even *provoke* those paths deterministically cannot claim to
survive them.

This module is the provocation half: a seed-reproducible
:class:`FaultPlan` (which panel executions on which engine misbehave,
and how) applied through the :class:`FaultyEngine` wrapper.  The recovery
half lives in :class:`~repro_torch.soc.runtime.SynergyRuntime`, configured with
a :class:`RetryPolicy` — a failed stealable panel is re-seeded onto a
surviving engine (exactly-once merge preserved), a dead worker's queued
and in-flight panels migrate to survivors, and repeated faults feed the
:class:`~repro_torch.soc.qos.HealthPolicy` EMA so flaky engines get
quarantined through the existing self-healing machinery.

Fault vocabulary (``FaultSpec.kind``):

* ``"raise"`` — the panel raises :class:`InjectedFault` instead of
  computing (a failed accelerator invocation).
* ``"corrupt"`` — the panel computes, then its float output is poisoned
  with NaN (silent data corruption; caught by the runtime's opt-in
  output-integrity guard, ``RetryPolicy.check_outputs``).  Integer
  outputs (int8 int32-exact partials) pass through unchanged — there is
  no "slightly wrong" int32 accumulator to model without breaking the
  bitwise contract the guard exists to protect.
* ``"slowdown"`` — the panel computes correctly but takes
  ``factor`` × longer (fixed), or ramps by ``ramp`` per affected call
  (progressive thermal throttling).  Feeds the health EMA naturally.  On
  a card the panel's time is read after its stream drained, so the delay
  scales the device work and not the launch.
* ``"stall"`` — the panel hangs for ``duration_s`` before completing
  (a wedged accelerator queue; recoverable via
  ``RetryPolicy.stall_timeout_s`` duplicate re-execution).
* ``"die"`` — the worker thread executing the panel dies mid-panel
  (:class:`WorkerKilled` propagates out of ``execute``); the runtime's
  heartbeat monitor detects the death and re-seeds the orphans.
* ``"drop"`` — the panel computes but its completion is lost
  (:class:`DroppedCompletion`): the worker moves on as if nothing
  happened, leaving the panel in-flight forever.  Only the stall sweep
  recovers it.

Determinism: a plan is a pure function of its specs — per-engine call
counters select which executions fault, so the same plan against the
same submission order injects the same faults.  ``FaultPlan.random``
derives a plan from a seed via ``random.Random`` (never global state).

The keystone invariant (tested in ``tests/test_faults.py``): for any
retryable plan, merged GEMM outputs and serving token streams are
**bitwise identical** to the fault-free run — int8 int32-exact panels
make this provable on any engine, and fp32 panels re-execute whole,
never partially.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Optional, Sequence

import torch

from repro_torch.engines.base import Engine

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultPlan", "FaultyEngine",
           "RetryPolicy", "InjectedFault", "CorruptOutput", "WorkerKilled",
           "DroppedCompletion", "PanelRetryExhausted", "wrap_pool"]

#: the closed fault vocabulary (see module docstring)
FAULT_KINDS = ("raise", "corrupt", "slowdown", "stall", "die", "drop")


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A panel execution failed by plan (the accelerator-invocation-error
    analog).  Retryable."""


class CorruptOutput(RuntimeError):
    """A panel's output failed the NaN/Inf integrity screen — raised both
    by the ``"corrupt"`` injection path (via the guard) and by the guard
    itself on genuinely corrupted engines.  Retryable."""


class WorkerKilled(BaseException):
    """Kills the worker thread mid-panel (``"die"``).  Deliberately NOT a
    ``RuntimeError``: nothing downstream may catch-and-continue it —
    the worker loop exits and the heartbeat monitor takes over."""


class DroppedCompletion(BaseException):
    """The panel computed but its completion signal was lost (``"drop"``).
    The worker survives and moves on; the submission never hears back.
    Only the runtime's stall sweep (duplicate re-execution) recovers it."""


class PanelRetryExhausted(RuntimeError):
    """A panel failed on every attempt the :class:`RetryPolicy` allowed.
    Carries the audit trail the flight recorder dumps."""

    def __init__(self, jobset_name: str, attempts: int,
                 engines: Sequence[str], last: BaseException):
        self.jobset_name = jobset_name
        self.attempts = attempts
        self.engines = list(engines)
        self.last = last
        super().__init__(
            f"panel of {jobset_name!r} failed {attempts} attempt(s) "
            f"on {self.engines}: {type(last).__name__}: {last}")


# ---------------------------------------------------------------------------
# Recovery policy (consumed by SynergyRuntime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How :class:`~repro_torch.soc.runtime.SynergyRuntime` survives panel
    faults.

    ``max_attempts``: total executions a panel may consume (first try
    included) before its submission fails with
    :class:`PanelRetryExhausted`.
    ``backoff_s``: delay before a retry is re-seeded (0 = immediate).
    ``avoid_failed_engine``: re-seed excludes engines the panel already
    failed on, unless no other eligible engine remains.
    ``check_outputs``: opt-in NaN/Inf screen on float panel partials —
    corruption becomes a retryable :class:`CorruptOutput` instead of a
    silently wrong merge.  Off by default: the screen costs one device
    reduction per panel.
    ``heartbeat_timeout_s``: a worker thread silent (dead) this long is
    declared failed and its queued + in-flight panels re-seed onto
    survivors.  The semantics are
    :class:`repro_torch.runtime.fault_tolerance.HeartbeatMonitor`'s — the
    monitor thread ticks one "step" per ``monitor_interval_s`` and the
    timeout is expressed in those steps — one definition, not two.
    ``stall_timeout_s``: a panel in flight this long is presumed wedged
    or dropped and a DUPLICATE attempt is re-seeded; first completion
    wins (idempotent merge), so a slow-but-alive original stays safe.
    None disables the sweep.
    ``monitor_interval_s``: monitor thread tick period."""

    max_attempts: int = 3
    backoff_s: float = 0.0
    avoid_failed_engine: bool = True
    check_outputs: bool = False
    heartbeat_timeout_s: float = 0.5
    stall_timeout_s: Optional[float] = None
    monitor_interval_s: float = 0.05

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.monitor_interval_s <= 0:
            raise ValueError("monitor_interval_s must be > 0")

    @property
    def timeout_steps(self) -> int:
        """``heartbeat_timeout_s`` in monitor ticks — the value handed to
        :class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor`."""
        return max(1, int(self.heartbeat_timeout_s
                          / self.monitor_interval_s))


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned misbehavior: executions ``at_call .. at_call+count-1``
    (0-based, per-engine counter of REAL panel executions) on ``engine``
    fault with ``kind``.

    ``factor``/``ramp`` parameterize ``"slowdown"`` (sleep the measured
    compute time × (factor − 1), ramping by ``ramp`` per faulted call);
    ``duration_s`` parameterizes ``"stall"``."""

    engine: str
    kind: str
    at_call: int = 0
    count: int = 1
    factor: float = 4.0
    ramp: float = 0.0
    duration_s: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if self.at_call < 0:
            raise ValueError("at_call must be >= 0")

    def hits(self, call: int) -> bool:
        return self.at_call <= call < self.at_call + self.count


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` injections.

    The plan itself is immutable scheduling data; ``injected`` is the
    mutable audit log the wrappers append to (thread-safe), so a test can
    assert exactly which faults actually fired."""

    def __init__(self, specs: Sequence[FaultSpec], seed: Optional[int] = None):
        self.specs = tuple(specs)
        self.seed = seed
        self._lock = threading.Lock()
        #: (engine, kind, call) tuples, in injection order
        self.injected: list[tuple[str, str, int]] = []

    def for_engine(self, name: str) -> tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.engine == name)

    def record(self, engine: str, kind: str, call: int) -> None:
        with self._lock:
            self.injected.append((engine, kind, call))

    def __repr__(self) -> str:
        return f"<FaultPlan seed={self.seed} specs={list(self.specs)}>"

    @classmethod
    def random(cls, seed: int, engines: Sequence[str], *,
               n_faults: int = 3, max_call: int = 8,
               kinds: Sequence[str] = ("raise", "corrupt", "slowdown"),
               ) -> "FaultPlan":
        """A seed-reproducible plan over ``engines``: ``n_faults`` specs
        drawn from ``kinds`` via ``random.Random(seed)`` (never global
        state — the same (seed, engines) always yields the same plan).
        Defaults draw only RETRYABLE kinds, the chaos-sweep contract."""
        rng = random.Random(seed)
        specs = [FaultSpec(engine=rng.choice(list(engines)),
                           kind=rng.choice(list(kinds)),
                           at_call=rng.randrange(max_call),
                           factor=rng.uniform(2.0, 6.0),
                           duration_s=rng.uniform(0.2, 1.0))
                 for _ in range(n_faults)]
        return cls(specs, seed=seed)


# ---------------------------------------------------------------------------
# The wrapper engine
# ---------------------------------------------------------------------------

class FaultyEngine(Engine):
    """Wraps a real engine, applying a :class:`FaultPlan` to its panel
    executions.

    Delegation is attribute-faithful: ``execute_int8`` /
    ``execute_weight_only`` / ``observe_amax`` / calibration hooks only
    exist on the wrapper when the inner engine has them, so every
    ``hasattr``-based capability probe in the runtime and serving layers
    sees the wrapped engine exactly as it would the real one.

    The per-call counter counts REAL panel executions (any of the execute
    entry points) and is touched without a lock: a pool engine executes
    only on its own worker thread, and the counter is advisory for any
    other caller."""

    def __init__(self, inner: Engine, plan: FaultPlan, *,
                 tracer=None):
        super().__init__(inner.name, set(inner.capabilities),
                         cost=inner._cost)
        self.inner = inner
        self.plan = plan
        self._specs = plan.for_engine(inner.name)
        self._calls = 0
        self._tracer = tracer
        # share the inner engine's telemetry: runtime counters must not
        # split between wrapper and wrapped
        self.telemetry = inner.telemetry
        for name in ("execute_int8", "execute_weight_only"):
            if hasattr(inner, name):
                setattr(self, name, self._wrap(getattr(inner, name)))

    # ------------------------------------------------------------ plumbing
    def __getattr__(self, name):
        # only consulted for attributes NOT set on the wrapper — i.e.
        # inner-engine extras (observe_amax, quantized, act_scale_for, ...)
        if name == "inner":          # guard: __init__ not yet complete
            raise AttributeError(name)
        return getattr(self.inner, name)

    def available(self) -> bool:
        return self.inner.available()

    def estimate(self, jobset, device=None) -> float:
        return self.inner.estimate(jobset, device)

    def recalibrate(self, measured_rate: float, alpha: float = 0.5,
                    device=None) -> float:
        out = self.inner.recalibrate(measured_rate, alpha, device)
        self._cost = self.inner._cost
        return out

    def cost_on(self, device):
        return self.inner.cost_on(device)

    # ------------------------------------------------------------ faulting
    def _due(self, call: int) -> Optional[FaultSpec]:
        for s in self._specs:
            if s.hits(call):
                return s
        return None

    def _emit(self, spec: FaultSpec, call: int) -> None:
        self.plan.record(self.name, spec.kind, call)
        tr = self._tracer
        if tr is None:
            from repro_torch.obs.trace import get_default_tracer
            tr = get_default_tracer()
        if tr is not None:
            # tag is "fault", not "kind" — emit()'s first positional IS kind
            tr.emit("fault_injected", self.name, fault=spec.kind,
                    call=call, at_call=spec.at_call)

    def _apply(self, fn, *args, **kwargs):
        call = self._calls
        self._calls += 1
        spec = self._due(call)
        if spec is None:
            return fn(*args, **kwargs)
        self._emit(spec, call)
        if spec.kind == "raise":
            raise InjectedFault(
                f"injected fault on {self.name!r} (call {call})")
        if spec.kind == "die":
            raise WorkerKilled(
                f"worker for {self.name!r} killed mid-panel (call {call})")
        if spec.kind == "stall":
            time.sleep(spec.duration_s)
            return fn(*args, **kwargs)
        if spec.kind == "slowdown":
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _wait_for_device(out)
            dt = time.perf_counter() - t0
            extra = spec.factor + spec.ramp * (call - spec.at_call) - 1.0
            if extra > 0:
                time.sleep(dt * extra)
            return out
        if spec.kind == "drop":
            fn(*args, **kwargs)          # the compute happens, then is lost
            raise DroppedCompletion(
                f"completion dropped on {self.name!r} (call {call})")
        # "corrupt": poison float outputs; integer partials pass through
        out = fn(*args, **kwargs)
        if torch.is_tensor(out) and torch.is_floating_point(out):
            return torch.full_like(out, float("nan"))
        return out

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            return self._apply(fn, *args, **kwargs)
        return wrapped

    def execute(self, a, b, *, bias=None, activation=None,
                tile=(256, 256, 256), out_dtype=None):
        return self._apply(self.inner.execute, a, b, bias=bias,
                           activation=activation, tile=tile,
                           out_dtype=out_dtype)

    def __repr__(self) -> str:
        return f"<FaultyEngine {self.name!r} plan={self.plan!r}>"


def _wait_for_device(out) -> None:
    """Block until the device work behind ``out`` is done.  On a card an
    engine returns once its kernels are queued, so a slowdown that timed
    the call alone would scale the launch and not the panel; the current
    stream is the worker's (the runtime runs a panel under it)."""
    if torch.is_tensor(out) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()


def wrap_pool(engines: Sequence[Engine], plan: FaultPlan, *,
              tracer=None) -> list[Engine]:
    """Wrap every engine the plan names; pass the rest through untouched
    (an unwrapped engine has zero fault-layer overhead)."""
    targeted = {s.engine for s in plan.specs}
    return [FaultyEngine(e, plan, tracer=tracer)
            if e.name in targeted else e for e in engines]
