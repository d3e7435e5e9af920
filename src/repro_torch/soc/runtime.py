"""SynergyRuntime — live work-stealing execution over engine pools (§4.3).

The dispatcher gives every GEMM a *router* (it picks ONE engine per
JobSet).  This module gives it an *executor*: a runtime that owns one
worker thread per engine, a per-engine job deque, and the paper's thief
protocol — the manager notices idle engines (the idle book), the stealer
moves jobs from the busiest victim queue at job granularity, guarded by the
shared tail policy in :mod:`repro_torch.soc.policy` (the same function the
discrete-event simulator applies).

Execution model
---------------
A *submission* is one JobSet plus its executable decomposition.  For a real
GEMM the unit of scheduling is a **row panel** — one grid row of the
paper's (t1, t2) tile jobs; every tile job belongs to exactly one panel, so
panels steal freely while the merge stays a concatenation (no cross-engine
accumulation).  Accounting-only submissions (serving prefill/decode
proxies) schedule at single tile-job granularity.

Engines come and go mid-run: ``add_engine`` / ``remove_engine`` (or the
process registry's ``register_engine`` / ``unregister_engine`` when
``follow_registry=True``) trigger a live rebalance — queued jobs are
re-seeded across the surviving pool proportional to cost-model rates.  This
is the paper's "adapt to different network configurations at runtime
without changing the hardware" as an API property.

Telemetry flows through the per-engine :class:`repro_torch.engines.Telemetry`
(cost-model ``busy_s`` on the simulator's accounting basis, plus measured
``wall_busy_s``/``idle_s`` and ``steals``), so the Table-6 utilization
metric reads the same counters as the dispatcher path.

On the card
-----------
A runtime lives on one device (``device=``, the card by default).  Its
workers rank and estimate engines with ``engine.cost_on(device)``, and
``submit_gemm`` refuses operands on another device.  On a card each worker
owns a CUDA stream: a panel runs under it, after the stream waits on an
event recorded on the submitter's stream (A was written there, e.g. by
im2col, and on the int8 path quantized there too), and the worker
synchronises its stream before the panel's time is read, so
``wall_busy_s``, recalibration and health time the panel and not its
launch; ``RetryPolicy.check_outputs``'s NaN/Inf screen is queued on that
stream too and read after the same synchronize.  Panel outputs are
marked as used on the submitter's stream, where the merge concatenates
them.  Launches go through ``ctypes``, which releases the GIL, so two
workers' launches can overlap; the rest of the worker loop holds it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.engines.base import CAP_GEMM, CAP_INT8, CAP_SIM, Engine
from repro_torch.engines.dispatch import JOB_CLASSES
from repro_torch.obs.flightrec import FlightRecorder
from repro_torch.obs.trace import get_default_tracer
from repro_torch.engines.registry import (add_registry_listener, get_engine,
                                          remove_registry_listener)
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.kernels.qmm import qmm_matmul
from repro_torch.quant.act import quantize_activations
from repro_torch.quant.quantize import dequant_finish
from .faults import (CorruptOutput, DroppedCompletion, PanelRetryExhausted,
                     RetryPolicy, WorkerKilled)
from .policy import lpt_pick, should_steal
from .qos import EngineHealth, HealthPolicy
from .qos_policy import (NEUTRAL_TAG, QosTag, effective_deadline,
                         qos_victim, queue_insert_index)

__all__ = ["SynergyRuntime", "RuntimeFuture", "RetryPolicy",
           "runtime_scope", "current_runtime", "is_concrete"]

#: idle-book wait quantum.  Wakeups are notify-driven (submit / pool change
#: / shutdown all notify_all); the timeout is only a lost-wakeup backstop.
_IDLE_WAIT_S = 0.5


def _admits_int8(job_class: Optional[str]) -> bool:
    """Whether a job class opts into int8 engines (the dispatcher's
    precision policy, read here so runtime splits honor the same
    opt-in invariant).  Unknown classes raise — a typo must not silently
    drop the routing the caller asked for."""
    if job_class is None:
        return False
    try:
        policy = JOB_CLASSES[job_class]
    except KeyError:
        raise KeyError(f"unknown job class {job_class!r}; known: "
                       f"{sorted(JOB_CLASSES)}") from None
    return CAP_INT8 in (policy.prefer | policy.require)


# ---------------------------------------------------------------------------
# Futures + submissions
# ---------------------------------------------------------------------------

class RuntimeFuture:
    """Completion handle for one submission."""

    def __init__(self, jobset):
        self.jobset = jobset
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        self._callbacks: list[Callable[["RuntimeFuture"], None]] = []
        #: engine name -> {"jobs", "est_s", "bytes", "steals"} for the share
        #: of this submission each engine actually executed.
        self.accounting: dict[str, dict] = {}
        #: panel retries this submission consumed (RetryPolicy runs only)
        self.retries = 0

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"submission {self.jobset.name!r} not done in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def add_done_callback(
            self, cb: Callable[["RuntimeFuture"], None]) -> None:
        """Run ``cb(self)`` when the submission completes (immediately if
        it already has).  This is how a dataflow graph adopts a
        submission as one of its nodes: the tail panel's completion
        decrements successor dependency counters without polling."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    # internal ------------------------------------------------------------
    def _finish(self, value: Any, error: Optional[BaseException]) -> None:
        self._value, self._error = value, error
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)


class _RuntimeJob:
    """One schedulable unit: ``n_jobs`` identical tile jobs of a submission.

    ``fn(engine) -> part`` does the actual compute (None = accounting-only);
    ``index`` is the merge slot.  ``stealable=False`` pins the job to the
    queue it was seeded on — used for real-array splits over MIXED-precision
    pools, where a steal would nondeterministically swap an fp32 panel for
    an int8 one (accounting-only jobs always steal freely).  ``int8_ok``
    carries the caller's precision opt-in ON the job, so every placement
    path — seed, steal, rebalance, engine removal, hotplug — enforces it:
    a job that never opted into int8 cannot land on a CAP_INT8 worker, no
    matter how the pool changes after submission.

    ``priority``/``deadline_at`` carry the submission's QoS tag the same
    way (see :mod:`repro_torch.soc.qos_policy`): every placement path orders by
    them, and a queue stays sorted non-increasing in priority, so the
    head is always the most urgent panel and the tail the most stealable
    one.  Neutral jobs (priority 0, no deadline) place exactly as the
    pre-QoS runtime did."""

    __slots__ = ("sub", "index", "fn", "n_jobs", "job_macs", "job_bytes",
                 "stealable", "int8_ok", "priority", "deadline_at",
                 "attempts", "failed_on")

    def __init__(self, sub: "_Submission", index: int, fn, n_jobs: int,
                 job_macs: int, job_bytes: int, stealable: bool = True,
                 int8_ok: bool = True, priority: int = 0,
                 deadline_at: float = math.inf):
        self.sub = sub
        self.index = index
        self.fn = fn
        self.n_jobs = n_jobs
        self.job_macs = job_macs
        self.job_bytes = job_bytes
        self.stealable = stealable
        self.int8_ok = int8_ok
        self.priority = priority
        self.deadline_at = deadline_at
        # retry bookkeeping (RetryPolicy runs only): executions consumed,
        # and engines this panel already failed on (None until the first
        # failure — the fault-free hot path never allocates the list)
        self.attempts = 0
        self.failed_on: Optional[list[str]] = None


class _Submission:
    def __init__(self, jobset, n_parts: int,
                 merge: Optional[Callable[[list], Any]],
                 on_done: Optional[Callable[["RuntimeFuture"], None]] = None):
        self.future = RuntimeFuture(jobset)
        self.merge = merge
        self.on_done = on_done
        self.parts: list = [None] * n_parts
        self.exec_counts = [0] * n_parts   # work-conservation audit trail
        self.future.execution_counts = self.exec_counts
        self.pending = n_parts
        #: idempotent-completion flags: a DUPLICATE completion for an
        #: already-done index (stall-sweep re-execution racing the slow
        #: original) is dropped whole — parts, accounting and the pending
        #: countdown see exactly one completion per index, so duplicate
        #: re-execution is always merge-safe
        self.done_flags = [False] * n_parts
        self.error: Optional[BaseException] = None
        self.lock = threading.Lock()

    def complete(self, job: _RuntimeJob, engine_name: str, part: Any,
                 err: Optional[BaseException], est_s: float,
                 stolen: bool) -> None:
        with self.lock:
            if self.done_flags[job.index]:
                return                     # first completion won the race
            self.done_flags[job.index] = True
            self.parts[job.index] = part
            self.exec_counts[job.index] += 1
            acct = self.future.accounting.setdefault(
                engine_name, {"jobs": 0, "est_s": 0.0, "bytes": 0,
                              "steals": 0})
            acct["jobs"] += job.n_jobs
            acct["est_s"] += est_s
            acct["bytes"] += job.n_jobs * job.job_bytes
            acct["steals"] += int(stolen)
            if err is not None and self.error is None:
                self.error = err
            self.pending -= 1
            last = self.pending == 0
        if not last:
            return
        if self.error is not None:
            self.future._finish(None, self.error)
        else:
            try:
                value = self.merge(self.parts) if self.merge else None
            except BaseException as e:      # merge bug must not hang callers
                self.future._finish(None, e)
            else:
                self.future._finish(value, None)
        if self.on_done is not None:
            self.on_done(self.future)


class _Worker:
    def __init__(self, engine: Engine, device: torch.device):
        self.engine = engine
        #: where the runtime's operands live: ranks the engine's cost model
        self.device = device
        #: this worker's CUDA stream (None off the card)
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        #: pinned host flag the integrity screen reads a card panel into
        #: (one panel at a time, read after the stream's synchronize)
        self.finite = (torch.empty((), dtype=torch.bool, pin_memory=True)
                       if self.stream is not None else None)
        self.queue: deque[_RuntimeJob] = deque()
        #: EngineHealth when the runtime runs a HealthPolicy, else None
        self.health: Optional[EngineHealth] = None
        self.thread: Optional[threading.Thread] = None
        self.stopped = False
        self.idle = False
        # per-runtime counters (engine.telemetry is process-global)
        self.jobs = 0
        self.steals = 0
        self.est_busy_s = 0.0
        self.wall_busy_s = 0.0
        self.idle_s = 0.0
        # recalibration window (zeroed by SynergyRuntime.recalibrate)
        self.cal_macs = 0
        self.cal_wall_s = 0.0

    @property
    def rate(self) -> float:
        try:
            return self.engine.cost_on(self.device).macs_per_s
        except NotImplementedError:
            return 1.0

    def job_time(self, macs: int, n_bytes: int) -> float:
        try:
            return self.engine.cost_on(self.device).job_time(macs, n_bytes)
        except NotImplementedError:
            return 0.0

    @property
    def quarantined(self) -> bool:
        return self.health is not None and self.health.quarantined


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class SynergyRuntime:
    """Work-stealing executor over a pool of registered engines.

    engines: engine names/instances; None = every non-sim GEMM-capable
    engine the default dispatcher would consider.  ``follow_registry=True``
    mirrors ``register_engine``/``unregister_engine`` into the live pool.
    ``device``: where the operands of ``submit_gemm`` live, the card by
    default (raises without one); pass ``"cpu"`` to run the engines' plain
    versions on the CPU.  Use as a context manager, or
    ``start()``/``shutdown()`` explicitly.
    """

    def __init__(self, engines: Optional[Iterable[Union[str, Engine]]] = None,
                 *, device: Union[str, torch.device, None] = None,
                 require: Iterable[str] = (CAP_GEMM,),
                 follow_registry: bool = False, name: str = "runtime",
                 recalibrate_every: Optional[int] = None,
                 recalibrate_alpha: float = 0.5,
                 rates_path: Optional[Union[str, os.PathLike]] = None,
                 health: Optional[HealthPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 tracer=None, flight_recorder=None):
        """``recalibrate_every=N`` makes the runtime self-calibrating: every
        N completed submissions it folds measured worker rates into the
        cost models (the serving analog of the paper's offline
        calibration) — no caller-driven ``recalibrate()`` needed.
        ``rates_path`` persists the learned ``macs_per_s`` to a JSON
        sidecar after each recalibration and re-applies it on
        construction, so a restarted process starts from the measured
        rates (e.g. the real qmm kernel's) instead of the nominal
        constants.  CAP_SIM engines are excluded from both directions.

        ``health=HealthPolicy(...)`` makes the pool SELF-HEALING: every
        worker's measured per-panel MAC rate feeds an EMA, a worker whose
        rate decays below the policy threshold is quarantined (deque
        rebalanced onto the survivors, cost model decayed to the measured
        rate, no new seeds or steals), probed on a cadence, and
        re-admitted once it measures healthy again (see
        :mod:`repro_torch.soc.qos`).  ``health=None`` (default) disables all
        of it — zero overhead, zero behavior change.

        ``retry=RetryPolicy(...)`` (see :mod:`repro_torch.soc.faults`) makes
        the pool FAULT-TOLERANT: a panel that raises (or fails the
        opt-in NaN/Inf output screen) is re-seeded onto a surviving
        engine instead of failing its submission — up to
        ``max_attempts`` executions, avoiding engines it already failed
        on — a worker thread that DIES is detected by a heartbeat
        monitor (the :class:`repro_torch.runtime.fault_tolerance.
        HeartbeatMonitor` semantics, ticked by a runtime monitor
        thread) and its queued + in-flight panels re-seed onto the
        survivors, and a panel in flight longer than
        ``stall_timeout_s`` gets a duplicate attempt (first completion
        wins — the merge is idempotent per panel index).  Every fault
        feeds the worker's health EMA when a ``HealthPolicy`` is also
        active, so chronically flaky engines quarantine through the
        same machinery as slow ones.  ``retry=None`` (default) keeps
        the first-error-wins behavior, zero overhead: no monitor
        thread, no in-flight registry.

        ``tracer=Tracer(...)`` (see :mod:`repro_torch.obs.trace`) records typed
        scheduling events — seed/enqueue/dequeue, panel spans, steals,
        quarantines — exportable as a Chrome trace.  ``tracer=None``
        falls back to the process default installed by
        ``repro_torch.obs.trace.set_default_tracer`` (e.g. by
        ``benchmarks/run.py --trace``); with neither, every
        instrumentation site is a single ``is None`` attribute check and
        scheduling is bitwise identical to the untraced runtime.  When a
        tracer is active, a :class:`~repro_torch.obs.flightrec.FlightRecorder`
        (auto-created unless ``flight_recorder`` is passed) dumps the
        event tail + ``stats()`` on every quarantine."""
        self.name = name
        self.device = resolve_device(device)
        self._tracer = tracer if tracer is not None else get_default_tracer()
        if flight_recorder is None and self._tracer is not None:
            flight_recorder = FlightRecorder(self._tracer)
        self._flight = flight_recorder
        self.require = frozenset(require)
        self._recal_every = recalibrate_every
        self._recal_alpha = recalibrate_alpha
        self._health = health
        self._retry = retry
        self._retries = 0
        self._worker_deaths = 0
        self._orphan_reseeds = 0
        #: panels currently executing, job -> (engine_name, t_start) —
        #: maintained ONLY under a RetryPolicy (the monitor's view of
        #: what a dead worker orphans / what the stall sweep re-seeds)
        self._live_panels: dict[_RuntimeJob, tuple[str, float]] = {}
        self._monitor: Optional[threading.Thread] = None
        self._quarantines = 0
        self._rates_path = os.fspath(rates_path) if rates_path else None
        self._completed = 0    # finished submissions (cadence counter)
        # RLock: submission-completion hooks can fire from paths that
        # already hold the runtime lock (cancel / orphan-fail)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._workers: dict[str, _Worker] = {}
        self._retired: list[threading.Thread] = []
        #: counters of removed engines, so stats() totals never go backwards
        self._retired_counters = {"jobs": 0, "steals": 0, "est_busy_s": 0.0,
                                  "wall_busy_s": 0.0, "idle_s": 0.0}
        self._started = False
        self._stopping = False
        self._rebalances = 0
        self._submissions = 0
        self._inflight = 0     # incomplete submissions (gates idle booking)
        self._listener = None
        #: active dataflow-graph runs (see repro_torch.soc.graph) —
        #: cancelled on shutdown so an abandoned DAG can never hang a
        #: reaper on workers that no longer exist
        self._graphs: set = set()
        #: lazy host-side executor for graph run nodes (im2col gathers,
        #: pooling) — NEVER an engine worker, so a host stage cannot stall
        #: an engine queue.  On a card its threads launch on the device's
        #: default stream, the stream submit_gemm orders and merges on
        self._host_pool = None
        if engines is None:
            from repro_torch.engines.dispatch import DEFAULT_DISPATCHER
            pool: list[Engine] = DEFAULT_DISPATCHER.candidates(require)
        else:
            pool = [get_engine(e) if isinstance(e, str) else e
                    for e in engines]
        if not pool:
            raise ValueError("SynergyRuntime needs at least one engine")
        for eng in pool:
            self._workers[eng.name] = self._new_worker(eng)
        self._follow_registry = follow_registry
        if self._rates_path:
            self._load_rates()

    def _new_worker(self, eng: Engine) -> _Worker:
        w = _Worker(eng, self.device)
        if self._health is not None:
            w.health = EngineHealth()
        return w

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "SynergyRuntime":
        with self._cond:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            for w in self._workers.values():
                self._spawn(w)
            if self._retry is not None and self._monitor is None:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, daemon=True,
                    name=f"synergy-{self.name}-monitor")
                self._monitor.start()
        if self._follow_registry and self._listener is None:
            self._listener = add_registry_listener(self._on_registry_event)
        return self

    def _spawn(self, w: _Worker) -> None:
        w.thread = threading.Thread(
            target=self._worker_loop, args=(w,), daemon=True,
            name=f"synergy-{self.name}-{w.engine.name}")
        w.thread.start()

    def shutdown(self, *, drain: bool = True,
                 timeout: float = 30.0) -> None:
        if self._listener is not None:
            remove_registry_listener(self._listener)
            self._listener = None
        with self._cond:
            if not self._started:
                return
            # graphs whose pending nodes would seed work AFTER the workers
            # exit can never complete — cancel them first (reap graphs
            # before shutting down to avoid this)
            for g in list(self._graphs):
                g.cancel("runtime shut down")
            if not drain:
                self._cancel_queued_locked("runtime shut down")
            self._stopping = True
            self._cond.notify_all()
            threads = [w.thread for w in self._workers.values()
                       if w.thread is not None] + self._retired
        for t in threads:
            t.join(timeout)
        with self._cond:
            self._started = False
            self._monitor = None       # stale monitor loops see the swap
            self._live_panels.clear()
            self._retired.clear()
            pool, self._host_pool = self._host_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _cancel_queued_locked(self, why: str) -> None:
        for w in self._workers.values():
            while w.queue:
                job = w.queue.popleft()
                job.sub.complete(job, w.engine.name, None,
                                 RuntimeError(why), 0.0, False)

    def __enter__(self) -> "SynergyRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------- pool changes
    @property
    def engine_names(self) -> list[str]:
        with self._lock:
            return list(self._workers)

    def find_engine(self, name: str) -> Optional[Engine]:
        """The live pool member under ``name`` (pool engines need not be
        in the process registry — accounting consumers resolve here)."""
        with self._lock:
            w = self._workers.get(name)
            return w.engine if w is not None else None

    def add_engine(self, engine: Union[str, Engine]) -> None:
        """Bring an engine online mid-run; queued work rebalances onto it."""
        eng = get_engine(engine) if isinstance(engine, str) else engine
        with self._cond:
            if eng.name in self._workers:
                return
            w = self._new_worker(eng)
            self._workers[eng.name] = w
            if self._started:
                self._spawn(w)
                self._rebalance_locked()
            self._cond.notify_all()

    def remove_engine(self, name: str) -> bool:
        """Retire an engine mid-run; its queued jobs move to survivors (the
        in-flight job, if any, finishes on the retiring engine, and its
        counters fold into the runtime totals).  Orphans keep their
        precision eligibility: an fp32-only panel re-seeds onto
        full-precision survivors, and FAILS its submission if none remain
        (see ``_seed_locked``) rather than silently quantizing."""
        with self._cond:
            w = self._workers.pop(name, None)
            if w is None:
                return False
            orphans = self._retire_worker_locked(w)
            if self._workers:
                self._seed_locked(orphans, affinity=None)
                self._rebalance_locked()
            else:
                for job in orphans:
                    job.sub.complete(job, name, None,
                                     RuntimeError("no engines left"), 0.0,
                                     False)
            self._cond.notify_all()
            return True

    def _retire_worker_locked(self, w: _Worker) -> list[_RuntimeJob]:
        w.stopped = True
        orphans = list(w.queue)
        w.queue.clear()
        if w.thread is not None:
            self._retired.append(w.thread)
        c = self._retired_counters
        c["jobs"] += w.jobs
        c["steals"] += w.steals
        c["est_busy_s"] += w.est_busy_s
        c["wall_busy_s"] += w.wall_busy_s
        c["idle_s"] += w.idle_s
        return orphans

    def _on_registry_event(self, event: str, engine: Engine) -> None:
        if not engine.supports(self.require):
            return
        if event == "register":
            # re-registration under the same name swaps the live engine
            # ATOMICALLY: the replacement inherits the old queue, so a
            # single-engine pool never transits through "no engines left"
            with self._cond:
                old = self._workers.pop(engine.name, None)
                orphans = (self._retire_worker_locked(old)
                           if old is not None else [])
                w = self._new_worker(engine)
                self._workers[engine.name] = w
                w.queue.extend(orphans)
                if self._started:
                    self._spawn(w)
                    self._rebalance_locked()
                self._cond.notify_all()
        elif event == "unregister":
            self.remove_engine(engine.name)

    def _rebalance_locked(self) -> None:
        """Gather every queued (unstarted) STEALABLE job and re-seed
        proportional to the current pool's cost-model rates.  Precision-
        pinned panels (mixed-pool splits) stay on the queue the LPT seed
        chose — a hotplug mid-GEMM must not silently move an fp32 panel
        onto an int8 engine.  (A REMOVED engine's pinned orphans do
        migrate — see remove_engine — there is no engine left to honor.)"""
        pending: list[_RuntimeJob] = []
        for w in self._workers.values():
            pinned = [j for j in w.queue if not j.stealable]
            pending.extend(j for j in w.queue if j.stealable)
            w.queue.clear()
            w.queue.extend(pinned)
        if pending:
            self._seed_locked(pending, affinity=None)
        self._rebalances += 1

    # --------------------------------------------------------- scheduling
    @staticmethod
    def _seed_order(jobs: Sequence[_RuntimeJob],
                    best_rate: float) -> Sequence[_RuntimeJob]:
        """Deadline-aware seed order: priority descending, then earliest
        EFFECTIVE deadline (deadline minus the fastest healthy member's
        cost-model service estimate) within a class, submission order as
        the stable tie-break.  All-neutral batches return unsorted — the
        pre-QoS FIFO order, byte for byte."""
        if all(j.priority == 0 and j.deadline_at == math.inf for j in jobs):
            return jobs

        def key(j: _RuntimeJob):
            est = (j.n_jobs * j.job_macs / best_rate if best_rate > 0
                   else 0.0)
            return (-j.priority, effective_deadline(j.deadline_at, est))

        return sorted(jobs, key=key)

    @staticmethod
    def _enqueue(q: deque, job: _RuntimeJob) -> None:
        """Priority insertion that keeps the deque sorted non-increasing
        in priority (head = most urgent, tail = most stealable).  Neutral
        traffic into a neutral queue is a plain O(1) append."""
        if not q or job.priority <= q[-1].priority:
            q.append(job)
        else:
            q.insert(queue_insert_index([j.priority for j in q],
                                        job.priority), job)

    def _seed_locked(self, jobs: Sequence[_RuntimeJob],
                     affinity: Optional[str]) -> None:
        """Seed jobs with per-job precision eligibility: a job whose
        ``int8_ok`` is False never lands on a CAP_INT8 worker (the
        dispatcher's opt-in invariant, enforced at the queue level so
        rebalances and removals preserve it too).  A job with NO eligible
        worker fails its submission instead of crashing the seed.

        QoS: jobs are seeded in deadline-aware order (priority, then
        effective deadline), quarantined workers are skipped unless the
        job has no healthy eligible engine, and each job enters its queue
        at its priority position (:func:`~repro_torch.soc.qos_policy.
        queue_insert_index`) — a decode panel lands ahead of queued bulk
        prefill panels, never mid-panel."""
        tr = self._tracer
        if tr is not None:
            tr.emit("seed", "manager", runtime=self.name,
                    n_jobs=len(jobs), affinity=affinity)
        workers = list(self._workers.values())
        is_int8 = [CAP_INT8 in w.engine.capabilities for w in workers]
        quar = [w.quarantined for w in workers]
        loads = [sum(j.n_jobs * w.job_time(j.job_macs, j.job_bytes)
                     for j in w.queue) for w in workers]
        best_rate = max((w.rate for w, q in zip(workers, quar) if not q),
                        default=0.0)
        avoid_on = (self._retry is not None
                    and self._retry.avoid_failed_engine)
        for job in self._seed_order(jobs, best_rate):
            elig = [i for i in range(len(workers))
                    if job.int8_ok or not is_int8[i]]
            idxs = [i for i in elig if not quar[i]]
            if avoid_on and job.failed_on:
                # retry placement: skip the engines this panel already
                # failed on — unless that leaves nowhere to go
                avoided = [i for i in idxs
                           if workers[i].engine.name not in job.failed_on]
                if avoided:
                    idxs = avoided
            if not idxs:
                # every eligible engine quarantined: degraded placement
                # beats failing the submission
                idxs = elig
            if not idxs:
                job.sub.complete(
                    job, "<unplaceable>", None,
                    RuntimeError("no precision-eligible engine in the pool "
                                 "for this job"), 0.0, False)
                continue
            ai = next((i for i in idxs
                       if workers[i].engine.name == affinity), None)
            if ai is None:
                # LPT-style seed (§3.1.1): smallest projected finish time
                # among eligible workers; stealing fixes the rest
                costs = [workers[i].job_time(job.job_macs, job.job_bytes)
                         * job.n_jobs for i in range(len(workers))]
                ai = lpt_pick(idxs, loads, costs)
            loads[ai] += (workers[ai].job_time(job.job_macs, job.job_bytes)
                          * job.n_jobs)
            self._enqueue(workers[ai].queue, job)
            if tr is not None:
                tr.emit("enqueue", workers[ai].engine.name,
                        jobset=job.sub.future.jobset.name,
                        n_jobs=job.n_jobs, priority=job.priority)

    def _try_steal_locked(self, thief: _Worker):
        """The stealer: priority-aware victim choice over VIABLE queues,
        shared tail-guard policy, steal from the TAIL (victims pop their
        own head).  A queue whose tail job is precision-pinned
        (mixed-pool panel), or whose tail the THIEF may not run (int8
        thief, non-opted-in job), is not viable — but other queues still
        are, so interleaved accounting traffic keeps stealing even while
        a pinned split is in flight.

        QoS: among viable victims, thieves prefer the one holding the
        LOWEST-priority tail (:func:`~repro_torch.soc.qos_policy.qos_victim` —
        bulk panels move out of the way first; queues are priority-sorted
        so a tail is always its queue's least important panel).  A
        quarantined thief steals nothing except its probation probe: one
        panel per ``probe_interval_s``, to re-measure itself."""
        h = thief.health
        probe = False
        if h is not None and h.quarantined:
            if not h.probe_due(time.monotonic(), self._health):
                return None
            probe = True
        thief_int8 = CAP_INT8 in thief.engine.capabilities
        # avoid_failed_engine must hold at STEAL time too: an engine whose
        # panels fault instantly is always hungry and would steal its own
        # failed retry straight back off the survivor it re-seeded to
        avoid = (self._retry is not None
                 and self._retry.avoid_failed_engine)
        names = [n for n, w in self._workers.items()
                 if n != thief.engine.name and w.queue
                 and w.queue[-1].stealable
                 and (w.queue[-1].int8_ok or not thief_int8)
                 and not (avoid and w.queue[-1].failed_on
                          and thief.engine.name in w.queue[-1].failed_on)]
        if not names:
            return None
        prios = [self._workers[n].queue[-1].priority for n in names]
        lens = [len(self._workers[n].queue) for n in names]
        victim = self._workers[names[qos_victim(prios, lens)]]
        fastest = max((w.rate for w in self._workers.values()
                       if not w.quarantined), default=thief.rate)
        rel = thief.rate / fastest if fastest > 0 else 1.0
        if should_steal(rel, len(victim.queue)):
            if probe:
                h.last_probe_s = time.monotonic()
            job = victim.queue.pop()
            tr = self._tracer
            if tr is not None:
                tr.emit("steal", thief.engine.name,
                        victim=victim.engine.name,
                        jobset=job.sub.future.jobset.name,
                        priority=job.priority, probe=probe)
            return job
        return None

    def _worker_loop(self, w: _Worker) -> None:
        while True:
            job, stolen = None, False
            with self._cond:
                while True:
                    if w.queue:
                        job = w.queue.popleft()
                        tr = self._tracer
                        if tr is not None:
                            tr.emit("dequeue", w.engine.name,
                                    jobset=job.sub.future.jobset.name,
                                    n_jobs=job.n_jobs)
                        break
                    if w.stopped:      # retired: never steal NEW work
                        return
                    job = self._try_steal_locked(w)
                    if job is not None:
                        stolen = True
                        break
                    if self._stopping:  # shutdown drain: all queues empty
                        return
                    # idle book: park until the manager (a submit/notify)
                    # wakes us.  Idle is booked only while a submission is
                    # actually outstanding, so busy_fraction measures
                    # utilization of the WORKLOAD, not runtime lifetime.
                    w.idle = True
                    t0 = time.perf_counter()
                    busy_elsewhere = self._inflight > 0
                    self._cond.wait(_IDLE_WAIT_S)
                    if busy_elsewhere:
                        dt = time.perf_counter() - t0
                        w.idle_s += dt
                        w.engine.telemetry.record_runtime(idle_s=dt)
                w.idle = False
            try:
                self._execute(w, job, stolen)
            except WorkerKilled:
                # injected mid-panel death: the thread exits without
                # completing its panel (the live-panel registry entry
                # survives for the heartbeat monitor to orphan-reseed)
                return
            if w.stopped:
                return

    def _execute(self, w: _Worker, job: _RuntimeJob, stolen: bool) -> None:
        eng = w.engine
        err, part, finite = None, None, None
        retry = self._retry
        screen = retry is not None and retry.check_outputs
        if retry is not None:
            with self._lock:
                self._live_panels[job] = (eng.name, time.monotonic())
        t0 = time.perf_counter()
        try:
            if job.fn is not None:
                if w.stream is None:
                    part = job.fn(eng)
                else:
                    # the panel runs on the worker's stream, and the worker
                    # waits for it: a launch returns in ~µs and would make
                    # the measured (recalibration, health) rate orders of
                    # magnitude too high.  The integrity screen is queued
                    # there too, so the one synchronize covers it
                    with torch.cuda.stream(w.stream):
                        part = job.fn(eng)
                        if screen:
                            finite = self._queue_screen(w, part)
                    w.stream.synchronize()
        except WorkerKilled:
            # mid-panel worker death: re-raise WITHOUT completing and
            # WITHOUT clearing the live-panel entry — the monitor reads
            # it to know what the corpse was holding
            raise
        except DroppedCompletion:
            # the panel computed but its completion was lost: the worker
            # moves on; only the stall sweep (which still sees the live
            # entry) can recover the submission
            return
        except BaseException as e:
            err = e
        dt = time.perf_counter() - t0
        tr = self._tracer
        if tr is not None:
            tags = {"jobset": job.sub.future.jobset.name,
                    "n_jobs": job.n_jobs, "stolen": stolen,
                    "priority": job.priority}
            if err is not None:
                tags["err"] = type(err).__name__
            # on the tracer's clock: the panel ended now, dt ago it began
            tr.span("panel", eng.name, tr.now() - dt, dt, **tags)
        est = job.n_jobs * w.job_time(job.job_macs, job.job_bytes)
        w.jobs += job.n_jobs
        w.steals += int(stolen)
        w.est_busy_s += est
        w.wall_busy_s += dt
        if job.fn is not None:
            # recalibration window: only REAL compute measures a rate —
            # accounting-only jobs finish in ~0 wall time at full MACs and
            # would blow the observed rate sky-high
            w.cal_macs += job.n_jobs * job.job_macs
            w.cal_wall_s += dt
        eng.telemetry.record_jobs(job.n_jobs, est, job.n_jobs * job.job_bytes,
                                  steals=int(stolen))
        eng.telemetry.record_runtime(wall_busy_s=dt)
        if (self._health is not None and job.fn is not None
                and err is None and dt > 0 and job.job_macs > 0):
            # self-healing: only REAL compute measures a health rate, for
            # the same reason recalibration ignores accounting-only jobs
            self._health_tick(w, job.n_jobs * job.job_macs / dt)
        if retry is not None:
            with self._lock:
                self._live_panels.pop(job, None)
            if err is None and screen and (
                    self._screen_output(part) if finite is None
                    else not bool(finite)):
                err = CorruptOutput(
                    f"panel of {job.sub.future.jobset.name!r} returned "
                    f"non-finite values on {eng.name!r}")
            if err is not None:
                err = self._maybe_retry(w, job, err)
                if err is None:
                    return             # re-seeded: another attempt runs
                part = None
        job.sub.complete(job, eng.name, part, err, est, stolen)

    # ------------------------------------------------------- self-healing
    def _health_tick(self, w: _Worker, rate: float) -> None:
        """Fold one measured per-panel rate into the worker's health EMA
        and act on the quarantine / readmission thresholds."""
        pol = self._health
        with self._cond:
            h = w.health
            if h is None or w.stopped:
                return
            h.observe(rate, pol)
            if h.should_quarantine(pol):
                self._quarantine_locked(w)
            elif h.quarantined and h.recovered(pol):
                self._readmit_locked(w)

    def _quarantine_locked(self, w: _Worker) -> None:
        """Quarantine a sick worker: decay its cost model to the MEASURED
        rate (planning must see the truth, not the nominal constant),
        drain its stealable queued panels onto the survivors via the
        hotplug seeding path, and stop seeding/stealing to it — it still
        runs its own pinned leftovers, and probes one stolen panel per
        ``probe_interval_s`` to earn readmission.  The LAST healthy
        worker is never quarantined: a degraded pool beats a dead one."""
        others = [o for o in self._workers.values()
                  if o is not w and not o.stopped and not o.quarantined]
        if not others:
            return
        h = w.health
        h.enter_quarantine(time.monotonic())
        self._quarantines += 1
        w.engine.telemetry.record_runtime(quarantines=1)
        tr = self._tracer
        if tr is not None:
            tr.emit("quarantine", w.engine.name, runtime=self.name,
                    health=h.health, ema_rate=h.ema_rate)
        if CAP_SIM not in w.engine.capabilities and h.ema_rate > 0:
            # alpha=1: the decayed measurement IS the engine's rate now
            w.engine.recalibrate(h.ema_rate, alpha=1.0, device=self.device)
        stealable = [j for j in w.queue if j.stealable]
        pinned = [j for j in w.queue if not j.stealable]
        w.queue.clear()
        w.queue.extend(pinned)
        if stealable:
            self._seed_locked(stealable, affinity=None)
        self._rebalances += 1
        self._cond.notify_all()
        if self._flight is not None:
            # post-mortem without a re-run: event tail + the stats view
            # AFTER the drain, so the dump shows where the work went
            self._flight.dump(
                "quarantine", stats=self.stats(),
                context={"runtime": self.name, "engine": w.engine.name,
                         "health": h.snapshot()})

    def _readmit_locked(self, w: _Worker) -> None:
        """Probation exit: the probes measured healthy again — restore the
        cost model to the recovered rate and rebalance queued work back
        across the full pool."""
        h = w.health
        h.exit_quarantine()
        tr = self._tracer
        if tr is not None:
            tr.emit("readmit", w.engine.name, runtime=self.name,
                    health=h.health, ema_rate=h.ema_rate)
        if CAP_SIM not in w.engine.capabilities and h.ema_rate > 0:
            w.engine.recalibrate(h.ema_rate, alpha=1.0, device=self.device)
        self._rebalance_locked()
        self._cond.notify_all()

    # ------------------------------------------------------ fault recovery
    def _monitor_loop(self) -> None:
        """The RetryPolicy's watchdog thread: one HeartbeatMonitor "step"
        per ``monitor_interval_s`` tick.  Each tick beats every worker
        whose thread is still alive; a worker silent for
        ``timeout_steps`` ticks (``heartbeat_timeout_s``) is declared
        dead and its queued + in-flight panels re-seed onto survivors.
        The monitor is rebuilt (everyone re-beaten at the current tick)
        whenever pool membership changes, so a hotplugged engine never
        starts life already timed out.  Also runs the stall sweep when
        ``stall_timeout_s`` is set."""
        pol = self._retry
        me = threading.current_thread()
        hb: Optional[HeartbeatMonitor] = None
        names: list[str] = []
        tick = 0
        while True:
            time.sleep(pol.monitor_interval_s)
            with self._cond:
                if (self._stopping or not self._started
                        or self._monitor is not me):
                    return
                cur = [n for n, w in self._workers.items() if not w.stopped]
                if hb is None or cur != names:
                    names = cur
                    hb = HeartbeatMonitor(
                        len(names), timeout_steps=pol.timeout_steps)
                    tick = 0
                tick += 1
                for h, n in enumerate(names):
                    w = self._workers.get(n)
                    if (w is not None and w.thread is not None
                            and w.thread.is_alive()):
                        hb.beat(h, tick)
                dead = [names[h] for h in hb.failed_hosts(tick)]
                for n in dead:
                    w = self._workers.get(n)
                    if w is not None and not w.stopped:
                        self._on_worker_death_locked(w)
                if dead:
                    hb = None          # membership changed: rebuild
                if pol.stall_timeout_s is not None:
                    self._stall_sweep_locked()

    def _on_worker_death_locked(self, w: _Worker) -> None:
        """A worker thread died (crash, ``WorkerKilled`` injection): pop
        it from the pool via the hotplug retirement path, reclaim BOTH
        its queued panels and the panel it died holding (the live-panel
        registry entry its crash left behind), and re-seed everything
        onto the survivors.  An empty surviving pool fails the orphans —
        same contract as ``remove_engine``."""
        name = w.engine.name
        self._workers.pop(name, None)
        orphans = self._retire_worker_locked(w)
        inflight = [job for job, (wn, _) in list(self._live_panels.items())
                    if wn == name]
        for job in inflight:
            self._live_panels.pop(job, None)
            if job.failed_on is None:
                job.failed_on = []
            if name not in job.failed_on:
                job.failed_on.append(name)
        orphans.extend(inflight)
        self._worker_deaths += 1
        tr = self._tracer
        if tr is not None:
            tr.emit("worker_death", name, runtime=self.name,
                    queued=len(orphans) - len(inflight),
                    in_flight=len(inflight))
        if self._workers and orphans:
            self._orphan_reseeds += len(orphans)
            if tr is not None:
                tr.emit("orphan_reseed", name, runtime=self.name,
                        n_jobs=len(orphans))
            self._seed_locked(orphans, affinity=None)
        else:
            for job in orphans:
                job.sub.complete(job, name, None,
                                 RuntimeError(f"worker {name!r} died with "
                                              "no engines left"), 0.0, False)
        self._cond.notify_all()
        if self._flight is not None:
            self._flight.dump(
                "worker_death", stats=self.stats(),
                context={"runtime": self.name, "engine": name,
                         "orphans": len(orphans),
                         "in_flight": len(inflight)})

    def _stall_sweep_locked(self) -> None:
        """Presume panels in flight past ``stall_timeout_s`` wedged (or
        their completion dropped) and re-seed a DUPLICATE attempt.  The
        per-index idempotent merge makes the duplicate safe: first
        completion wins, so a slow-but-alive original costs nothing but
        the redundant compute."""
        pol = self._retry
        now = time.monotonic()
        stalled = [(job, wn) for job, (wn, t0) in self._live_panels.items()
                   if now - t0 >= pol.stall_timeout_s]
        if not stalled:
            return
        tr = self._tracer
        for job, wn in stalled:
            self._live_panels.pop(job, None)
            dup = _RuntimeJob(job.sub, job.index, job.fn, job.n_jobs,
                              job.job_macs, job.job_bytes, job.stealable,
                              job.int8_ok, job.priority, job.deadline_at)
            dup.attempts = job.attempts + 1
            dup.failed_on = [wn] if pol.avoid_failed_engine else []
            self._retries += 1
            job.sub.future.retries += 1
            if tr is not None:
                tr.emit("panel_retry", wn,
                        jobset=job.sub.future.jobset.name,
                        attempt=dup.attempts, err="stall")
            self._seed_locked([dup], affinity=None)
        self._cond.notify_all()

    def _maybe_retry(self, w: _Worker, job: _RuntimeJob,
                     err: BaseException) -> Optional[BaseException]:
        """Decide a failed panel's fate under the RetryPolicy.  Returns
        None when the panel was re-seeded for another attempt (the
        submission hears nothing), or the error to complete with —
        :class:`PanelRetryExhausted` once the budget ran out.  Every
        fault also feeds the worker's health EMA, so a chronically
        faulty engine quarantines through the self-healing machinery."""
        retry = self._retry
        if not isinstance(err, Exception):
            return err                 # WorkerKilled etc. never retry here
        name = job.sub.future.jobset.name
        with self._cond:
            job.attempts += 1
            if job.failed_on is None:
                job.failed_on = []
            if w.engine.name not in job.failed_on:
                job.failed_on.append(w.engine.name)
            if w.health is not None and self._health is not None:
                w.health.record_fault(self._health)
                if w.health.should_quarantine(self._health):
                    self._quarantine_locked(w)
            if job.attempts >= retry.max_attempts:
                exhausted = PanelRetryExhausted(name, job.attempts,
                                                job.failed_on, err)
                if self._flight is not None:
                    self._flight.dump(
                        "retry_exhausted", stats=self.stats(),
                        context={"runtime": self.name, "jobset": name,
                                 "attempts": job.attempts,
                                 "engines": list(job.failed_on),
                                 "last_error": f"{type(err).__name__}: "
                                               f"{err}"})
                return exhausted
            self._retries += 1
            job.sub.future.retries += 1
            tr = self._tracer
            if tr is not None:
                tr.emit("panel_retry", w.engine.name, jobset=name,
                        attempt=job.attempts, err=type(err).__name__)
            if retry.backoff_s > 0:
                t = threading.Timer(retry.backoff_s, self._reseed_retry,
                                    args=(job,))
                t.daemon = True
                t.start()
            else:
                self._seed_locked([job], affinity=None)
                self._cond.notify_all()
        return None

    def _reseed_retry(self, job: _RuntimeJob) -> None:
        """Backoff-timer body: re-seed one retried panel, or fail it if
        the runtime went away while it waited."""
        with self._cond:
            if not self._started or self._stopping:
                job.sub.complete(
                    job, "<retry>", None,
                    RuntimeError("runtime shut down before retry"),
                    0.0, False)
                return
            self._seed_locked([job], affinity=None)
            self._cond.notify_all()

    @staticmethod
    def _screen_output(part) -> bool:
        """True when a panel partial fails the NaN/Inf integrity screen.
        Float outputs only: the int8 path's int32 accumulators cannot
        encode a NaN, and casting them through float to check would cost
        exactness for nothing."""
        if not torch.is_tensor(part) or not torch.is_floating_point(part):
            return False
        return not bool(torch.isfinite(part).all())

    @staticmethod
    def _queue_screen(w: _Worker, part) -> Optional[torch.Tensor]:
        """The screen of a card panel's partial, queued on the current
        stream (the worker's) into the worker's pinned flag: it is read
        after the worker's one synchronize, with no second sync and
        without waiting behind the submitter's stream.  None when the
        screen skips ``part`` (:meth:`_screen_output` then says so on the
        host)."""
        if not torch.is_tensor(part) or not torch.is_floating_point(part):
            return None
        w.finite.copy_(torch.isfinite(part).all(), non_blocking=True)
        return w.finite

    # -------------------------------------------------------- submissions
    def _on_submission_done(self, fut: RuntimeFuture) -> None:
        with self._cond:
            self._inflight -= 1
            self._completed += 1
            recal_due = (self._recal_every is not None
                         and self._completed % self._recal_every == 0)
            # one split GEMM is still ONE gemm: credit it to the engine
            # that executed the largest share (dispatcher-path parity)
            eng = None
            if fut.accounting:
                dom = max(fut.accounting,
                          key=lambda n: fut.accounting[n]["jobs"])
                w = self._workers.get(dom)
                eng = w.engine if w is not None else None
        if eng is not None:
            eng.telemetry.record_jobs(0, 0.0, 0, gemms=1)
        if recal_due:
            # auto-recalibration cadence: consume the measurement window
            # opened N submissions ago and persist what it taught us
            self._save_rates(self.recalibrate(self._recal_alpha))

    # -------------------------------------------------- rate persistence
    def _load_rates(self) -> None:
        """Re-apply persisted measured rates (the serving analog of the
        paper's offline calibration surviving a power cycle).  A missing
        or unreadable sidecar means a fresh start, never an error."""
        try:
            with open(self._rates_path) as f:
                data = json.load(f).get("macs_per_s", {})
        except (OSError, ValueError):
            return
        for w in self._workers.values():
            rate = data.get(w.engine.name)
            if rate and rate > 0 and CAP_SIM not in w.engine.capabilities:
                # alpha=1: the sidecar IS the measured rate, not a hint
                w.engine.recalibrate(float(rate), alpha=1.0,
                                     device=self.device)

    def _save_rates(self, updated: dict[str, float]) -> None:
        """Merge freshly learned rates into the JSON sidecar (atomically:
        a crash mid-write must not corrupt the previous calibration)."""
        if not self._rates_path or not updated:
            return
        data: dict = {}
        try:
            with open(self._rates_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            pass
        rates = data.setdefault("macs_per_s", {})
        rates.update(updated)
        tmp = f"{self._rates_path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self._rates_path)
        except OSError:
            pass               # persistence is best-effort, never fatal

    # ------------------------------------------------- durable snapshots
    def quiesce(self, timeout: float = 30.0) -> bool:
        """Wait until no submission is in flight (a quiescent boundary a
        crash-consistent snapshot can be taken at).  Admission is the
        CALLER's job to stop — this only waits out what was already
        submitted.  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def state_snapshot(self) -> dict:
        """Learned state worth surviving a process crash: per-engine
        calibrated rates (what the sidecar persists, read from the live
        cost models) and full health records.  JSON-safe."""
        with self._lock:
            rates = {}
            health = {}
            for name, w in self._workers.items():
                if CAP_SIM not in w.engine.capabilities:
                    try:
                        rates[name] = float(
                            w.engine.cost_on(self.device).macs_per_s)
                    except NotImplementedError:
                        pass
                if w.health is not None:
                    health[name] = w.health.export_state()
        return {"macs_per_s": rates, "health": health}

    def restore_state(self, state: dict) -> None:
        """Re-apply :meth:`state_snapshot` onto the current pool.  Only
        engines present in both the snapshot and the pool are touched
        (the pool may have been reconfigured across the restart)."""
        rates = state.get("macs_per_s", {})
        health = state.get("health", {})
        with self._lock:
            workers = dict(self._workers)
        for name, w in workers.items():
            rate = rates.get(name)
            if rate and rate > 0 and CAP_SIM not in w.engine.capabilities:
                # alpha=1: the snapshot IS the measured rate, as _load_rates
                w.engine.recalibrate(float(rate), alpha=1.0,
                                     device=self.device)
            if w.health is not None and name in health:
                w.health.import_state(health[name])

    def _submit_jobs(self, jobset, units: list[tuple], merge,
                     affinity: Optional[str],
                     stealable: bool = True,
                     int8_ok: bool = True,
                     qos: Optional[QosTag] = None) -> RuntimeFuture:
        """units: list of (fn, n_jobs, job_macs, job_bytes)."""
        tag = qos or NEUTRAL_TAG
        sub = _Submission(jobset, len(units), merge,
                          on_done=self._on_submission_done)
        jobs = [_RuntimeJob(sub, i, fn, n_jobs, macs, nbytes, stealable,
                            int8_ok, tag.priority, tag.deadline_at)
                for i, (fn, n_jobs, macs, nbytes) in enumerate(units)]
        with self._cond:
            if not self._started:
                raise RuntimeError(f"runtime {self.name!r} is not started")
            self._submissions += 1
            self._inflight += 1
            self._seed_locked(jobs, affinity)
            self._cond.notify_all()
        return sub.future

    @staticmethod
    def _accounting_units(jobset, granularity: str) -> list[tuple]:
        """The (fn=None, n_jobs, macs, bytes) scheduling units of one
        accounting-only JobSet at ``"job"`` or ``"row"`` granularity."""
        j = next(jobset.jobs()) if jobset.num_jobs else None
        if j is None:
            return []
        if granularity == "job":
            return [(None, 1, j.macs, j.bytes_moved)] * jobset.num_jobs
        gm, gn = jobset.grid        # "row": one unit per grid row of tiles
        return [(None, gn, j.macs, j.bytes_moved)] * gm

    def submit(self, jobset, *, affinity: Optional[str] = None,
               granularity: str = "job",
               qos: Optional[QosTag] = None) -> RuntimeFuture:
        """Accounting-only submission: the JobSet's tile jobs are scheduled
        (and stolen) across the pool, booking cost-model busy time per
        engine, with no array compute.  This is how serving prefill/decode
        proxies flow through the runtime."""
        return self.submit_many([jobset], affinity=affinity,
                                granularity=granularity, qos=qos)[0]

    def submit_many(self, jobsets, *, affinity: Optional[str] = None,
                    granularity: str = "job",
                    qos: Optional[QosTag] = None) -> list[RuntimeFuture]:
        """Batched accounting submission — the server-scale amortization
        path: every JobSet of one admission wave goes through
        ONE manager-lock acquisition, one LPT seeding pass over ALL the
        batch's jobs, and one worker wakeup, instead of a lock + seed +
        notify per request.  Each jobset still completes as its own
        submission (own future, own accounting, own recalibration-cadence
        tick), so callers reap per-request accounting exactly as with N
        separate :meth:`submit` calls — only the dispatch overhead is
        shared.  Empty jobsets return already-finished futures in place."""
        tag = qos or NEUTRAL_TAG
        futs: list[RuntimeFuture] = []
        jobs: list[_RuntimeJob] = []
        n_live = 0
        for jobset in jobsets:
            units = self._accounting_units(jobset, granularity)
            if not units:
                fut = RuntimeFuture(jobset)
                fut._finish(None, None)
                futs.append(fut)
                continue
            sub = _Submission(jobset, len(units), None,
                              on_done=self._on_submission_done)
            jobs.extend(_RuntimeJob(sub, i, fn, n_jobs, macs, nbytes,
                                    priority=tag.priority,
                                    deadline_at=tag.deadline_at)
                        for i, (fn, n_jobs, macs, nbytes)
                        in enumerate(units))
            futs.append(sub.future)
            n_live += 1
        if n_live:
            with self._cond:
                if not self._started:
                    raise RuntimeError(
                        f"runtime {self.name!r} is not started")
                self._submissions += n_live
                self._inflight += n_live
                self._seed_locked(jobs, affinity)
                self._cond.notify_all()
        return futs

    def submit_graph(self, nodes, edges, *, affinity: Optional[str] = None,
                     granularity: str = "job", name: str = "graph",
                     qos: Optional[QosTag] = None, node_retries: int = 0):
        """Submit a dependency GRAPH of nodes: each node is a
        :class:`~repro_torch.core.job.JobSet` (accounting-only) or a
        :class:`repro_torch.soc.graph.GraphNode` (host compute / nested
        ``submit_gemm``); ``edges`` is an iterable of ``(pred, succ)``
        index pairs.  A node's work enters the pool the moment its last
        predecessor's tail panel lands: the completion callback decrements
        the successor's dependency counter under the manager lock and
        LPT-seeds the newly ready units into the existing worker deques,
        so stealing and hotplug rebalances apply to graph work
        unchanged.  Returns a
        :class:`repro_torch.soc.graph.GraphFuture` (per-node values,
        merged accounting, ``cancel()``).  ``node_retries=N`` relaunches a
        failed node (whole, as a fresh submission) up to N times before
        its descendants are cancelled — the graph-level complement of
        the runtime's panel-level :class:`RetryPolicy`.

        On a card, run nodes launch on the default stream, where an
        adopted ``submit_gemm`` enqueues its merge before the node
        completes: a successor reads a predecessor's value in stream
        order, with no event of its own."""
        from .graph import _GraphRun
        run = _GraphRun(self, nodes, edges, affinity=affinity,
                        granularity=granularity, name=name, qos=qos,
                        node_retries=node_retries)
        run.start()
        return run.future

    def _host_submit(self, fn, *args) -> None:
        """Run ``fn(*args)`` on the runtime's host-side executor (graph
        run nodes).  Lazy: a runtime without graphs never spawns it."""
        import concurrent.futures
        with self._lock:
            if self._host_pool is None:
                self._host_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=2,
                    thread_name_prefix=f"synergy-{self.name}-host")
            pool = self._host_pool
        pool.submit(fn, *args)

    @staticmethod
    def _drain_error(error: BaseException, job: _RuntimeJob) -> BaseException:
        """A PER-JOB copy of a drain error.  Completing multiple jobs with
        the SAME exception instance raises one object into every waiter
        thread — each ``raise`` rewrites ``__traceback__``, so concurrent
        waiters see each other's (cross-contaminated) tracebacks.  Each
        drained jobset gets its own instance, naming the jobset it
        drained."""
        name = job.sub.future.jobset.name
        try:
            return type(error)(f"{error} [drained jobset {name!r}]")
        except Exception:
            # error types with non-message constructors still get a
            # fresh per-job instance, just a plainer one
            return RuntimeError(f"{type(error).__name__}: {error} "
                                f"[drained jobset {name!r}]")

    def _drain_jobs_locked(self, predicate, error: BaseException) -> int:
        """Remove queued (unstarted) jobs matching ``predicate`` from every
        worker deque, completing each with a PER-JOB copy of ``error``
        (see :meth:`_drain_error`); in-flight jobs are untouched.  The
        cancellation half of ``GraphFuture.cancel``: a failed upstream
        node must not leave orphan panels running."""
        n = 0
        for w in self._workers.values():
            drained = [j for j in w.queue if predicate(j)]
            if not drained:
                continue
            kept = [j for j in w.queue if not predicate(j)]
            w.queue.clear()
            w.queue.extend(kept)
            for job in drained:
                job.sub.complete(job, w.engine.name, None,
                                 self._drain_error(error, job), 0.0, False)
            n += len(drained)
        return n

    def submit_gemm(self, a, b, *, jobset, bias=None, activation=None,
                    tile=(256, 256, 256), out_dtype=None,
                    affinity: Optional[str] = None,
                    job_class: Optional[str] = None,
                    observe_acts: bool = True,
                    qos: Optional[QosTag] = None) -> RuntimeFuture:
        """Split one GEMM's tile jobs across the pool as row panels; the
        future's result is the merged ``act(A @ B + bias)``.  ``a``, ``b``
        and ``bias`` must live on the runtime's device.

        Every panel executes at fp32 output precision and the requested
        ``out_dtype`` is applied ONCE to the merged result, so partials
        never round twice.

        Precision is OPT-IN, matching the dispatcher's invariant: unless
        ``job_class`` admits int8 (decode), every panel carries
        ``int8_ok=False`` and can never be placed on a CAP_INT8 worker —
        at seed time, by a steal, by a hotplug rebalance, or on engine
        removal.

        An opted-in GEMM whose activation scale has been calibrated takes
        the **int32-partial path** instead: the activations (and, on first
        use, the weights) quantize ONCE at submit time, every panel
        computes the raw int8×int8 int32 accumulator on the qmm kernel
        (exact integer math — bitwise identical on every engine, so these
        panels steal freely even across precision classes), and the merge
        concatenates the partials and applies ``dequant_finish`` exactly
        once.  The submission also feeds the calibrator (one host sync for
        max|a|), so the first decode split calibrates and the rest run
        quantized; ``observe_acts=False`` skips that feed, for a caller
        that calibrates on its own cadence.

        Otherwise mixed-pool panels are pinned to the deterministic LPT
        seed (stealable=False) — stealing an fp32 panel across precision
        classes would make the merged numerics a function of thread
        timing — and panels landing on a quantized engine run its
        weight-only fallback (never the order-dependent online path).

        On a card, the panels wait for an event recorded on the caller's
        current stream after the quantization, and the merge runs on that
        stream."""
        for t in (a, b, bias):
            if t is not None and t.device != self.device:
                raise ValueError(f"runtime {self.name!r} runs on "
                                 f"{self.device}, got an operand on "
                                 f"{t.device}")
        ts_m = jobset.ts_m
        m = a.shape[0]
        gm, gn = jobset.grid
        j = next(jobset.jobs())
        final_dtype = out_dtype or a.dtype
        int8_ok = _admits_int8(job_class)
        # quantizes A (and W) on the caller's stream: before the event
        plan = (self._plan_int8_split(a, b, observe=observe_acts)
                if int8_ok else None)
        caller, ready = None, None
        if self.device.type == "cuda":
            caller = torch.cuda.current_stream(self.device)
            ready = torch.cuda.Event()
            ready.record(caller)

        def on_worker(compute):
            """``compute(eng)`` as a panel: on the card it waits for the
            caller's operands first, and keeps its part's block from reuse
            until the caller's stream, where the merge reads it, is past
            it."""
            def fn(eng: Engine):
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                part = compute(eng)
                if caller is not None:
                    part.record_stream(caller)
                return part
            return fn

        def on_caller(merge_parts):
            def merge(parts: list):
                with (torch.cuda.stream(caller) if caller is not None
                      else contextlib.nullcontext()):
                    return merge_parts(parts[0] if len(parts) == 1
                                       else torch.cat(parts, 0))
            return merge

        rows = [(t1 * ts_m, min((t1 + 1) * ts_m, m)) for t1 in range(gm)]
        if plan is not None:
            qw, act_scale, a_q = plan

            def make_qfn(r0: int, r1: int):
                def compute(eng: Engine):
                    fn8 = getattr(eng, "execute_int8", None)
                    if fn8 is not None:
                        return fn8(a_q[r0:r1], qw, tile=tile)
                    # any engine computes the exact integer partial
                    # through the shared kernel (steals/hotplug-safe)
                    return qmm_matmul(a_q[r0:r1], qw.q, qw.scale,
                                      fuse_dequant=False)
                return on_worker(compute)

            units = [(make_qfn(r0, r1), gn, j.macs, j.bytes_moved)
                     for r0, r1 in rows]
            merge_q = on_caller(lambda acc: dequant_finish(
                acc, qw, act_scale=act_scale, bias=bias,
                activation=activation, out_dtype=final_dtype))
            return self._submit_jobs(jobset, units, merge_q, affinity,
                                     stealable=True, int8_ok=True, qos=qos)

        def make_fn(r0: int, r1: int):
            def compute(eng: Engine):
                ex = getattr(eng, "execute_weight_only", eng.execute)
                return ex(a[r0:r1], b, bias=bias, activation=activation,
                          tile=tile, out_dtype=torch.float32)
            return on_worker(compute)

        units = [(make_fn(r0, r1), gn, j.macs, j.bytes_moved)
                 for r0, r1 in rows]
        merge = on_caller(lambda y: y.to(final_dtype))

        # the mixed check and the enqueue must be one atomic step: a
        # hotplug between them would enqueue stealable panels into a
        # now-mixed pool and break the determinism pin (the Condition's
        # underlying RLock makes the nested acquire in _submit_jobs safe)
        with self._cond:
            mixed = self._mixed_precision_pool()
            return self._submit_jobs(jobset, units, merge,
                                     None if mixed else affinity,
                                     stealable=not mixed, int8_ok=int8_ok,
                                     qos=qos)

    def _plan_int8_split(self, a, b, observe: bool = True):
        """Plan the shared quantization of an opted-in GEMM: observe the
        live activations into the pool's quantized engine (unless the
        caller feeds the calibrator itself — ``observe=False``), and —
        once a scale is published for this (k, n) shape — quantize
        activations and weights ONCE for the whole split.  Returns
        ``(qw, act_scale, a_q)`` or None (no quantized engine in the pool,
        or the shape still warming up)."""
        with self._lock:
            engs = [w.engine for w in self._workers.values()]
        qengs = [e for e in engs
                 if CAP_INT8 in e.capabilities
                 and hasattr(e, "execute_int8")
                 and hasattr(e, "act_scale_for")]
        if not qengs:
            return None
        qeng = qengs[0]
        k, n = b.shape
        if observe:
            qeng.observe_activations(a, k, n)  # decode feeds the calibrator
        scale = qeng.act_scale_for(k, n)
        if scale is None:
            return None
        return qeng.quantized(b), scale, quantize_activations(a, scale)

    def _mixed_precision_pool(self) -> bool:
        """True when the live pool mixes int8 and full-precision engines
        (numerics then depend on which engine runs which panel)."""
        with self._lock:
            classes = {CAP_INT8 in w.engine.capabilities
                       for w in self._workers.values()}
        return len(classes) > 1

    def run_matmul(self, jobset, a, b, *, bias=None, activation=None,
                   tile=(256, 256, 256), out_dtype=None,
                   affinity: Optional[str] = None,
                   job_class: Optional[str] = None,
                   timeout: float = 300.0,
                   qos: Optional[QosTag] = None):
        """Blocking ``submit_gemm`` — what ``synergy_matmul`` calls under a
        :func:`runtime_scope`.  Returns (result, accounting)."""
        fut = self.submit_gemm(a, b, jobset=jobset, bias=bias,
                               activation=activation, tile=tile,
                               out_dtype=out_dtype, affinity=affinity,
                               job_class=job_class, qos=qos)
        return fut.result(timeout), fut.accounting

    # ----------------------------------------------------- recalibration
    def recalibrate(self, alpha: float = 0.5, *,
                    min_wall_s: float = 1e-4) -> dict[str, float]:
        """Steal-aware cost recalibration: fold each worker's MEASURED
        rate (MACs executed / wall seconds busy, real compute only) back
        into its engine's ``CostModel.macs_per_s`` via an EMA.

        LPT seeding, steal tail-guards and dispatcher ranking all read the
        cost model, so a mis-calibrated engine (cost says fast, hardware
        says slow) stops being over-seeded after a few windows — the
        planning analog of what the straggler rebalancer already does for
        SPMD shares.  Each call consumes the measurement window opened by
        the previous one.  CAP_SIM engines are never touched: their cost
        models are the PAPER's calibrated constants and their execute is a
        host-side oracle, so a measured host rate would corrupt every DES
        and planner result.  Returns ``{engine: macs_per_s now in
        effect}`` for the workers that had enough signal."""
        updated: dict[str, float] = {}
        with self._lock:
            windows = [(w, w.cal_macs, w.cal_wall_s)
                       for w in self._workers.values()]
            for w, _, _ in windows:
                w.cal_macs = 0
                w.cal_wall_s = 0.0
        for w, macs, wall_s in windows:
            if (wall_s < min_wall_s or macs <= 0
                    or CAP_SIM in w.engine.capabilities):
                continue
            updated[w.engine.name] = w.engine.recalibrate(
                macs / wall_s, alpha, device=self.device)
        return updated

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            per = {}
            for name, w in self._workers.items():
                denom = w.wall_busy_s + w.idle_s
                per[name] = {
                    "jobs": w.jobs, "steals": w.steals,
                    "est_busy_s": w.est_busy_s,
                    "wall_busy_s": w.wall_busy_s, "idle_s": w.idle_s,
                    "busy_fraction": w.wall_busy_s / denom if denom else 0.0,
                    "queued": len(w.queue),
                    "health": (w.health.health if w.health is not None
                               else None),
                    "quarantined": w.quarantined,
                    "faults": (w.health.faults if w.health is not None
                               else 0),
                }
            ests = [p["est_busy_s"] for p in per.values()]
            agg = (sum(ests) / (len(ests) * max(ests))
                   if ests and max(ests) > 0 else 0.0)
            retired = dict(self._retired_counters)
            return {
                "engines": per,
                "retired": retired,
                "submissions": self._submissions,
                "rebalances": self._rebalances,
                "quarantines": self._quarantines,
                "retries": self._retries,
                "worker_deaths": self._worker_deaths,
                "orphan_reseeds": self._orphan_reseeds,
                # totals include retired engines' work so a hot-unplug
                # never makes the counters go backwards
                "total_jobs": sum(p["jobs"] for p in per.values())
                + retired["jobs"],
                "total_steals": sum(p["steals"] for p in per.values())
                + retired["steals"],
                # Table-6 analog on the cost-model basis: total busy over
                # pool-size x makespan-proxy (busiest CURRENT engine's est)
                "aggregate_busy_fraction": agg,
            }

    def reset_stats(self) -> None:
        with self._lock:
            for w in self._workers.values():
                w.jobs = w.steals = 0
                w.est_busy_s = w.wall_busy_s = w.idle_s = 0.0
            self._submissions = 0
            self._rebalances = 0
            self._quarantines = 0
            self._retries = 0
            self._worker_deaths = 0
            self._orphan_reseeds = 0

    def scope(self):
        """``with rt.scope(): ...`` — route every ``synergy_matmul`` in the
        process through this runtime (see :func:`runtime_scope`)."""
        return runtime_scope(self)

    def __repr__(self) -> str:
        return (f"<SynergyRuntime {self.name!r} "
                f"engines={self.engine_names}>")


# ---------------------------------------------------------------------------
# Scope plumbing (how synergy_matmul finds the runtime)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_runtime() -> Optional[SynergyRuntime]:
    """The innermost runtime scope active in THIS thread (scopes are
    strictly thread-local, so a scope in one thread never hijacks GEMMs —
    or explicit ``engine=`` pins — in unrelated threads).  Components that
    fan work out to their own threads propagate the scope explicitly:
    ``ThreadedPipeline.run`` captures the caller's scope and re-enters it
    in every stage worker."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def runtime_scope(rt: SynergyRuntime):
    """Route every ``synergy_matmul`` in this thread under the block
    through ``rt``: JobSets are SPLIT across the pool and merged, instead
    of routed whole to one engine.  Starts the runtime if needed; does not
    shut it down on exit."""
    rt.start()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(rt)
    try:
        yield rt
    finally:
        stack.pop()


def is_concrete(*tensors) -> bool:
    """Runtime splitting needs tensors with data: a meta tensor (shape
    propagation only) keeps single-engine dispatch."""
    return not any(t is not None and t.is_meta for t in tensors)
