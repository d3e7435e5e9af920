"""Pure QoS scheduling policy — priorities, deadlines, fair shares.

Like :mod:`repro_torch.soc.policy`, this module is decision functions ONLY: the
live :class:`~repro_torch.soc.SynergyRuntime`, the virtual-time
:class:`~repro_torch.soc.SimRuntime` twin, and the serving admission layer all
import THESE, so a QoS decision made in simulation is the decision made on
live engines (the conformance tests assert function identity).

Semantics
---------
* **Priority** is an integer; HIGHER runs first.  0 is the neutral class —
  jobs with no QoS tag behave exactly as before this module existed
  (FIFO seed order, tail-of-queue placement), so an untagged workload is
  bitwise-indistinguishable from the pre-QoS runtime.
* **Deadlines** are absolute instants on the scheduler's clock (wall
  ``time.monotonic()`` live, virtual seconds in the sim).  Within one
  priority class, seeding orders by *effective* deadline — the latest
  start that still meets the SLO, ``deadline - cost-model estimate`` —
  the deadline-aware LPT of the tentpole.
* **Queues stay sorted** non-increasing in priority: a new job enters
  ahead of strictly-lower-priority queued work and behind its peers
  (FIFO within class).  Workers pop their own HEAD and thieves steal the
  TAIL, so a queue's tail is always its least important panel — which is
  exactly what :func:`qos_victim` sends thieves after.  Preemption is
  therefore at panel granularity: no panel is ever killed mid-flight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from .policy import pick_victim

__all__ = ["QosClass", "QosTag", "NEUTRAL_TAG", "DEFAULT_CLASS",
           "INTERACTIVE", "BULK", "BEST_EFFORT",
           "PREFILL_PRIORITY_OFFSET", "effective_deadline",
           "queue_insert_index", "qos_victim", "FairShare"]


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One tenant-facing service class.

    ``priority``: integer rank (higher runs first; 0 = neutral).
    ``deadline_s``: relative SLO deadline a request of this class gets by
    default (None = no deadline).
    ``weight``: fair-share weight under admission contention.
    ``sheddable``: may be degraded to int8-only decode by the server's
    load-shedding ladder before anything is rejected.
    """

    name: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    weight: float = 1.0
    sheddable: bool = False


DEFAULT_CLASS = QosClass()
INTERACTIVE = QosClass("interactive", priority=10, deadline_s=1.0,
                       weight=4.0)
BULK = QosClass("bulk", priority=-10, weight=1.0, sheddable=True)
BEST_EFFORT = QosClass("best-effort", priority=-20, weight=0.5,
                       sheddable=True)

#: prefill work of a class queues one notch BELOW its decode: decode-class
#: panels preempt bulk prefill panels at chunk boundaries (the serving
#: layer's ``prefill_chunk_macs`` graph chunks are the preemption quantum), while
#: a high-priority tenant's prefill still outranks a bulk tenant's decode.
PREFILL_PRIORITY_OFFSET = -1


@dataclasses.dataclass(frozen=True)
class QosTag:
    """The scheduler-facing tag one submission carries: resolved priority
    plus an ABSOLUTE deadline on the scheduler's clock (``math.inf`` =
    none).  Built by the serving layer from a :class:`QosClass` and the
    request's admission stamp; ``None`` anywhere a tag is accepted means
    :data:`NEUTRAL_TAG`."""

    priority: int = 0
    deadline_at: float = math.inf

    @classmethod
    def for_decode(cls, qos: QosClass, deadline_at: float = math.inf
                   ) -> "QosTag":
        return cls(qos.priority, deadline_at)

    @classmethod
    def for_prefill(cls, qos: QosClass, deadline_at: float = math.inf
                    ) -> "QosTag":
        return cls(qos.priority + PREFILL_PRIORITY_OFFSET, deadline_at)


NEUTRAL_TAG = QosTag()


def effective_deadline(deadline_at: float, est_s: float) -> float:
    """The latest start instant that still meets ``deadline_at`` given a
    cost-model service estimate — the EDF key of the deadline-aware LPT
    seed (earliest effective deadline first WITHIN a priority class)."""
    return deadline_at - est_s


def queue_insert_index(queue_priorities: Sequence[int],
                       priority: int) -> int:
    """Where a job of ``priority`` enters a priority-sorted deque: ahead
    of the first strictly-lower-priority queued job, behind its peers
    (FIFO within class).  With an all-neutral queue this is ``len(q)`` —
    plain append, the pre-QoS behavior."""
    for i, p in enumerate(queue_priorities):
        if p < priority:
            return i
    return len(queue_priorities)


def qos_victim(tail_priorities: Sequence[int],
               queue_lens: Sequence[int]) -> int:
    """Victim choice among viable queues: thieves prefer victims holding
    the LOWEST-priority tail panel (move bulk work out of the way; a
    victim's high-priority head stays put for the victim itself to run
    next), breaking ties by the busiest queue exactly as
    :func:`repro_torch.soc.policy.pick_victim` always has.  All-neutral tails
    reduce to ``pick_victim`` verbatim."""
    lo = min(tail_priorities)
    idxs = [i for i, p in enumerate(tail_priorities) if p == lo]
    return idxs[pick_victim([queue_lens[i] for i in idxs])]


class FairShare:
    """Stride-scheduling virtual time: weighted fair admission across
    tenants under overload.  Each admitted request advances its tenant's
    virtual time by ``1/weight``; the next pick is the highest-priority
    tenant with the smallest virtual time (deadline as the final
    tie-break).  A tenant that was idle rejoins at the current minimum,
    so it cannot hoard credit and starve the others."""

    def __init__(self) -> None:
        self._vt: dict[str, float] = {}

    def pick(self, candidates: Sequence[tuple]) -> str:
        """``candidates``: ``(name, priority, head_deadline_at, weight)``
        per tenant with pending work.  Returns the tenant to admit from
        (does NOT charge — call :meth:`charge` once the pop commits)."""
        self.join(name for name, _, _, _ in candidates)
        return min(candidates,
                   key=lambda c: (-c[1], self._vt[c[0]], c[2], c[0]))[0]

    def join(self, names) -> None:
        """Enter unseen tenants at the current floor (the no-hoarding
        rule).  Factored out of :meth:`pick` so journal replay — which
        forces recorded admissions instead of re-picking — applies the
        SAME entry rule and restored virtual times match exactly."""
        floor = min(self._vt.values()) if self._vt else 0.0
        for name in names:
            if name not in self._vt:
                self._vt[name] = floor

    def charge(self, name: str, weight: float) -> None:
        self._vt[name] = (self._vt.get(name, 0.0)
                          + 1.0 / max(weight, 1e-9))

    def snapshot(self) -> dict[str, float]:
        return dict(self._vt)

    def restore(self, vt: dict) -> None:
        """Adopt a :meth:`snapshot` — a restored server resumes fair
        admission with the exact virtual times the crashed one had."""
        self._vt = {str(k): float(v) for k, v in vt.items()}
