"""The unified Engine abstraction (paper §3: "a unified abstraction of the
heterogeneous accelerators").

The paper's F-PEs, S-PEs and NEON cores all present the same contract to the
runtime: take a tile job, return the output tile, at a calibrated rate.  This
module lifts that contract into the framework proper so *every* compute
backend — the ``torch.matmul`` engine, the hand-written CUDA tile kernel,
the plain fp32 oracle, the simulated Zynq PEs, or any engine a user
registers — is interchangeable behind one dispatch surface:

  * :class:`CostModel` — calibrated rate constants (the planning oracle the
    schedulers and the dispatcher share).
  * :class:`Telemetry` — per-engine counters (jobs run, busy seconds, bytes
    moved) aggregated by :class:`repro_torch.core.synergy_mm.SynergyTrace`.
  * :class:`Engine`    — name + capabilities + cost model + ``execute``.

Capabilities are plain strings; the dispatcher routes a GEMM only to engines
advertising every required capability.  The core vocabulary:

  ``gemm``      executes dense GEMMs (``execute`` is implemented)
  ``epilogue``  fuses bias + activation into the GEMM (no extra HBM trip)
  ``grad``      safe under autograd (used by training paths)
  ``tiled``     executes through the fixed-size tile-job decomposition
  ``interpret`` kernel engine that runs its plain version on CPU tensors
  ``sim``       cost-model-only paper PE (executes via the plain oracle)
  ``oracle``    numerical reference; never auto-selected for speed
  ``int8``      int8 quantized path (low precision, high rate; NOT
                grad-safe — round/clip kill the weight gradient)
  ``vpu``       vector-unit-only execution (no matrix unit) — the analog of
                the paper's NEON SIMD cores
"""

from __future__ import annotations

import abc
import dataclasses
import math
import threading
from typing import Callable, Optional

__all__ = [
    "CostModel", "Telemetry", "Engine",
    "CAP_GEMM", "CAP_EPILOGUE", "CAP_GRAD", "CAP_TILED", "CAP_INTERPRET",
    "CAP_SIM", "CAP_ORACLE", "CAP_INT8", "CAP_VPU",
]

CAP_GEMM = "gemm"
CAP_EPILOGUE = "epilogue"
CAP_GRAD = "grad"
CAP_TILED = "tiled"
CAP_INTERPRET = "interpret"
CAP_SIM = "sim"
CAP_ORACLE = "oracle"
CAP_INT8 = "int8"
CAP_VPU = "vpu"


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibrated engine rates — the shared planning oracle.

    ``macs_per_s``   sustained MAC rate on tile jobs.
    ``dispatch_s``   per-job dispatch overhead (the paper's ReconOS
                     delegate-thread round trip; 0 for on-die engines).
    ``bytes_per_s``  copy/stream bandwidth (im2col, layout transforms).
    ``ops_per_s``    non-MAC elementwise rate (pool/act/norm stages).
    """

    macs_per_s: float
    dispatch_s: float = 0.0
    bytes_per_s: float = math.inf
    ops_per_s: float = math.inf

    def job_time(self, job_macs: int, job_bytes: int = 0) -> float:
        """Seconds for ONE tile job: roofline max of compute and traffic,
        plus the dispatch overhead."""
        compute = job_macs / self.macs_per_s
        memory = job_bytes / self.bytes_per_s if job_bytes else 0.0
        return max(compute, memory) + self.dispatch_s

    def estimate(self, jobset) -> float:
        """Seconds to run every job of one GEMM's JobSet on this engine.
        All jobs of a JobSet are identical fixed-size tiles (§3.2.1), so
        this is num_jobs * per-job time."""
        if jobset.num_jobs == 0:   # degenerate GEMM (e.g. empty prompt)
            return 0.0
        job = next(jobset.jobs())
        return jobset.num_jobs * self.job_time(job.macs, job.bytes_moved)

    def scaled(self, factor: float) -> "CostModel":
        """A view of this model at ``factor``x the MAC rate (heterogeneous
        pool members expressed relative to a base engine)."""
        return dataclasses.replace(self, macs_per_s=self.macs_per_s * factor)


@dataclasses.dataclass
class Telemetry:
    """Per-engine dispatch AND runtime counters.

    ``busy_s`` is the cost-model estimate of seconds of engine time routed
    here (recorded at trace/dispatch time — the same accounting basis the
    discrete-event simulator and the roofline use).  The runtime counters
    are fed by the work-stealing runtime's workers: ``steals`` is the
    number of jobs this engine executed that it took from ANOTHER engine's
    queue, ``wall_busy_s``/``idle_s`` are measured worker-thread seconds
    executing jobs / waiting for work.  Updates are locked: ThreadedPipeline
    stages and runtime workers write from concurrent threads."""

    gemms: int = 0
    jobs: int = 0
    busy_s: float = 0.0
    bytes_moved: int = 0
    steals: int = 0
    wall_busy_s: float = 0.0
    idle_s: float = 0.0
    #: times this engine was quarantined by a self-healing pool
    quarantines: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def record(self, jobset, est_s: float) -> None:
        n_bytes = 0
        if jobset.num_jobs:
            n_bytes = jobset.num_jobs * next(jobset.jobs()).bytes_moved
        self.record_jobs(jobset.num_jobs, est_s, n_bytes, gemms=1)

    def record_jobs(self, n_jobs: int, est_s: float, n_bytes: int = 0, *,
                    gemms: int = 0, steals: int = 0) -> None:
        """Fine-grained accounting for PARTIAL jobsets — the runtime books
        each engine's actual share of a split GEMM here."""
        with self._lock:
            self.gemms += gemms
            self.jobs += n_jobs
            self.busy_s += est_s
            self.bytes_moved += n_bytes
            self.steals += steals

    def record_runtime(self, *, wall_busy_s: float = 0.0,
                       idle_s: float = 0.0, quarantines: int = 0) -> None:
        """Measured worker-thread time + health events (live runtime
        only)."""
        with self._lock:
            self.wall_busy_s += wall_busy_s
            self.idle_s += idle_s
            self.quarantines += quarantines

    @property
    def busy_fraction(self) -> float:
        """Measured busy / (busy + idle) of this engine's runtime worker
        (the live analog of the simulator's Table-6 utilization).  Reads
        both fields under the lock: a concurrent ``record_runtime`` /
        ``merge`` must not tear the ratio (busy from one window, idle
        from another).  Note the worker books an idle window only AFTER
        its ``cond.wait`` returns, so a mid-window snapshot UNDERCOUNTS
        idle — it can never double-count it (regression-tested)."""
        with self._lock:
            denom = self.wall_busy_s + self.idle_s
            return self.wall_busy_s / denom if denom > 0 else 0.0

    def merge(self, other: "Telemetry") -> None:
        snap = other.snapshot()
        with self._lock:
            self.gemms += snap.gemms
            self.jobs += snap.jobs
            self.busy_s += snap.busy_s
            self.bytes_moved += snap.bytes_moved
            self.steals += snap.steals
            self.wall_busy_s += snap.wall_busy_s
            self.idle_s += snap.idle_s
            self.quarantines += snap.quarantines

    def snapshot(self) -> "Telemetry":
        with self._lock:
            return Telemetry(self.gemms, self.jobs, self.busy_s,
                             self.bytes_moved, self.steals,
                             self.wall_busy_s, self.idle_s,
                             self.quarantines)

    def reset(self) -> None:
        with self._lock:
            self.gemms = 0
            self.jobs = 0
            self.busy_s = 0.0
            self.bytes_moved = 0
            self.steals = 0
            self.wall_busy_s = 0.0
            self.idle_s = 0.0
            self.quarantines = 0


class Engine(abc.ABC):
    """One compute backend behind the unified dispatch surface.

    Subclasses implement :meth:`execute` (a 2-D GEMM with fused epilogue)
    and either pass a :class:`CostModel` to ``__init__`` or override
    :meth:`cost_on` for device-dependent rates."""

    def __init__(self, name: str, capabilities: frozenset[str] | set[str],
                 cost: Optional[CostModel] = None):
        self.name = name
        self.capabilities = frozenset(capabilities)
        self._cost = cost
        self.telemetry = Telemetry()

    # ---- planning interface ---------------------------------------------
    @property
    def cost(self) -> CostModel:
        """The cost model on the port's default device."""
        return self.cost_on(None)

    def cost_on(self, device) -> CostModel:
        """The cost model that ranks this engine for operands on
        ``device`` (a ``torch.device``; None = the port's default device).
        Engines whose rate depends on where the operands live override
        this; the base model is device-independent."""
        if self._cost is None:
            raise NotImplementedError(f"engine {self.name!r} has no cost model")
        return self._cost

    def estimate(self, jobset, device=None) -> float:
        """Seconds to run this JobSet here on operands that live on
        ``device`` — the dispatcher's ranking key."""
        return self.cost_on(device).estimate(jobset)

    def available(self) -> bool:
        """Whether the engine can run on the current backend right now."""
        return True

    def recalibrate(self, observed_macs_per_s: float,
                    alpha: float = 0.5, device=None) -> float:
        """EMA-blend a measured MAC rate into this engine's cost model
        (steal-aware recalibration: the runtime feeds measured
        ``wall_busy_s`` back so LPT seeding adapts to observed speed).
        The blend starts from the CURRENT effective model on ``device``
        (stored, or computed for that device) and persists in ``_cost``;
        builtin engines with device-dependent rates honor the stored model
        once set.  Returns the rate now in effect."""
        current = self.cost_on(device)
        if observed_macs_per_s <= 0:
            return current.macs_per_s
        blended = ((1.0 - alpha) * current.macs_per_s
                   + alpha * observed_macs_per_s)
        self._cost = dataclasses.replace(current, macs_per_s=blended)
        return blended

    def supports(self, required) -> bool:
        return frozenset(required) <= self.capabilities

    # ---- execution interface --------------------------------------------
    @abc.abstractmethod
    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        """C = act(A @ B + bias) for 2-D ``a (m, k)`` and ``b (k, n)``."""

    def __repr__(self) -> str:
        caps = ",".join(sorted(self.capabilities))
        return f"<{type(self).__name__} {self.name!r} [{caps}]>"
