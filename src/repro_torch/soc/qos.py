"""repro_torch.soc.qos — multi-tenant QoS: tenants, admission, engine health.

Three concerns layered over :class:`~repro_torch.soc.SynergyRuntime` and
:class:`~repro_torch.core.serving.SynergyServer`:

* **Service classes** (:class:`~repro_torch.soc.qos_policy.QosClass`, re-exported
  here) attach priorities and SLO deadlines to submissions; the pure
  decision functions live in :mod:`repro_torch.soc.qos_policy` so the live
  runtime and the virtual-time sim share them verbatim.
* **Tenancy** (:class:`Tenant`, :class:`AdmissionRejected`): per-tenant
  bounded queues with weighted fair admission and a load-shedding ladder —
  degrade sheddable traffic to int8-only decode (the existing job-class
  routing) before anything is rejected; rejections carry a cost-model
  retry-after.
* **Self-healing pools** (:class:`HealthPolicy`, :class:`EngineHealth`):
  the :class:`repro_torch.runtime.straggler.StragglerRebalancer` EMA wired into
  the live runtime.  Each worker's measured MAC rate feeds an EMA; a rate
  that decays below ``quarantine_below`` x its healthy baseline gets the
  engine quarantined — its deque rebalanced onto the survivors (the
  hotplug machinery) and its cost model decayed to the measured rate —
  then probed on a cadence and re-admitted once ``readmit_above`` x the
  baseline holds again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .qos_policy import (BEST_EFFORT, BULK, DEFAULT_CLASS, INTERACTIVE,
                         NEUTRAL_TAG, QosClass, QosTag)

__all__ = ["QosClass", "QosTag", "NEUTRAL_TAG", "DEFAULT_CLASS",
           "INTERACTIVE", "BULK", "BEST_EFFORT",
           "Tenant", "AdmissionRejected",
           "HealthPolicy", "EngineHealth"]


# ---------------------------------------------------------------------------
# Tenancy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant of a :class:`~repro_torch.core.serving.SynergyServer`.

    ``qos``: the service class every request of this tenant inherits
    (a request's own ``deadline_s`` overrides the class default).
    ``max_pending``: bound of this tenant's pending queue (None = the
    server-wide ``max_pending``)."""

    name: str
    qos: QosClass = DEFAULT_CLASS
    max_pending: Optional[int] = None


class AdmissionRejected(RuntimeError):
    """A request was refused admission (tenant queue at its bound, after
    the shedding ladder already degraded what it could).  ``retry_after_s``
    is the cost-model estimate of when capacity frees up — the serving
    analog of HTTP 429 + Retry-After."""

    def __init__(self, tenant: str, retry_after_s: float,
                 reason: str = "pending queue full"):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(
            f"tenant {tenant!r}: {reason} "
            f"(retry after ~{self.retry_after_s:.3f}s)")


# ---------------------------------------------------------------------------
# Engine health — the straggler EMA, live
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Quarantine/readmission thresholds for self-healing pools.

    ``alpha``: EMA weight of the newest per-panel measured rate (the same
    smoothing :class:`repro_torch.runtime.straggler.StragglerRebalancer` applies
    to step times).
    ``quarantine_below``: quarantine when the EMA rate drops below this
    fraction of the engine's own healthy baseline (its peak EMA — relative
    to ITSELF, so paced, sim and real engines are judged alike).
    ``readmit_above``: probation exit — re-admit once the probed EMA is
    back above this fraction of the baseline.
    ``min_samples``: observations before any quarantine decision (a cold
    engine's first panels must not condemn it).
    ``probe_interval_s``: how often a quarantined worker may steal ONE
    panel to re-measure itself.
    ``min_probe_samples``: recovered probes required before readmission.
    """

    alpha: float = 0.5
    quarantine_below: float = 0.5
    readmit_above: float = 0.8
    min_samples: int = 3
    probe_interval_s: float = 0.25
    min_probe_samples: int = 2


class EngineHealth:
    """Mutable per-worker health record (guarded by the runtime's manager
    lock).  ``baseline`` is the peak healthy EMA; ``health`` is the
    current EMA relative to it (1.0 = nominal)."""

    __slots__ = ("ema_rate", "baseline", "samples", "quarantined",
                 "quarantined_at", "last_probe_s", "probe_samples",
                 "quarantines", "faults")

    def __init__(self) -> None:
        self.ema_rate = 0.0
        self.baseline = 0.0
        self.samples = 0
        self.quarantined = False
        self.quarantined_at: Optional[float] = None
        self.last_probe_s = 0.0
        self.probe_samples = 0
        self.quarantines = 0
        self.faults = 0

    @property
    def health(self) -> float:
        return (self.ema_rate / self.baseline if self.baseline > 0
                else 1.0)

    def snapshot(self) -> dict:
        """JSON-safe view for flight-recorder dumps and metrics export."""
        return {"ema_rate": self.ema_rate, "baseline": self.baseline,
                "health": self.health, "samples": self.samples,
                "quarantined": self.quarantined,
                "quarantines": self.quarantines,
                "probe_samples": self.probe_samples,
                "faults": self.faults}

    def export_state(self) -> dict:
        """Full state for durable snapshots — unlike :meth:`snapshot`
        (a display view), this covers every slot so a restored worker
        resumes with its learned baseline and quarantine status intact."""
        return {s: getattr(self, s) for s in self.__slots__}

    def import_state(self, state: dict) -> None:
        for s in self.__slots__:
            if s in state:
                setattr(self, s, state[s])

    def observe(self, rate: float, policy: HealthPolicy) -> None:
        """Fold one measured per-panel MAC rate into the EMA."""
        self.ema_rate = (rate if self.samples == 0
                         else policy.alpha * rate
                         + (1.0 - policy.alpha) * self.ema_rate)
        self.samples += 1
        if self.quarantined:
            self.probe_samples += 1
        else:
            self.baseline = max(self.baseline, self.ema_rate)

    def record_fault(self, policy: HealthPolicy) -> None:
        """Fold one FAULT (raised panel, corrupted output) into the record:
        count it, and drive the EMA toward zero — a fault is a panel that
        produced no useful work, i.e. a measured rate of 0.  Repeated
        faults therefore push the engine through the SAME quarantine
        threshold a thermal collapse would (one machinery, not two)."""
        self.faults += 1
        self.observe(0.0, policy)

    def should_quarantine(self, policy: HealthPolicy) -> bool:
        if self.quarantined:
            return False
        if (self.baseline == 0 and self.samples >= policy.min_samples
                and self.faults >= policy.min_samples):
            # never produced a single healthy panel — only faults.  The
            # relative-to-baseline test can't condemn it (there IS no
            # baseline), but min_samples straight faults can.
            return True
        return (self.samples >= policy.min_samples
                and self.baseline > 0
                and self.ema_rate < policy.quarantine_below * self.baseline)

    def probe_due(self, now: float, policy: HealthPolicy) -> bool:
        return (self.quarantined
                and now - self.last_probe_s >= policy.probe_interval_s)

    def recovered(self, policy: HealthPolicy) -> bool:
        return (self.quarantined
                and self.probe_samples >= policy.min_probe_samples
                and self.baseline > 0
                and self.ema_rate >= policy.readmit_above * self.baseline)

    def enter_quarantine(self, now: float) -> None:
        self.quarantined = True
        self.quarantined_at = now
        self.last_probe_s = now
        self.probe_samples = 0
        self.quarantines += 1

    def exit_quarantine(self) -> None:
        self.quarantined = False
        self.quarantined_at = None
        self.probe_samples = 0
