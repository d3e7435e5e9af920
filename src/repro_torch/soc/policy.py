"""The ONE work-stealing policy (paper §4.3) shared by every executor.

The thief protocol has three actors in the paper — the *manager* notices an
idle cluster (the idle book), the *stealer* picks a victim queue and moves a
job.  The decision itself is two pure functions, and the discrete-event
simulator (:func:`repro_torch.core.scheduler.simulate`), the live
:class:`repro_torch.soc.SynergyRuntime` workers, and the virtual-time
:class:`repro_torch.soc.SimRuntime` all import THESE so a steal decision made in
simulation is the decision made on live engines for identical cost models.

The QoS layer (:mod:`repro_torch.soc.qos_policy`) composes with — never replaces
— these functions: deadline-aware seeding still places with
:func:`lpt_pick`, and priority-aware victim choice
(:func:`~repro_torch.soc.qos_policy.qos_victim`) restricts the candidate set by
tail priority and then breaks ties with :func:`pick_victim` verbatim, so
an all-neutral workload takes exactly the decisions written here.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["STEAL_RATE_FLOOR", "STEAL_QUEUE_DEPTH", "should_steal",
           "pick_victim", "lpt_pick"]

#: a thief at >= this rate (relative to the fastest pool member) may steal
#: unconditionally; slower thieves only steal from deep queues.
STEAL_RATE_FLOOR = 0.9

#: queue depth above which even a slow thief helps: stealing one of many
#: queued jobs cannot make the slow engine the frame's straggler.
STEAL_QUEUE_DEPTH = 2


def should_steal(thief_rel_rate: float, victim_queue_len: int) -> bool:
    """Tail guard (§4.3): on the last jobs of a layer a 2x-slower engine
    would become the straggler that stalls the whole frame, so a slow
    thief only steals while the victim queue is deep."""
    if victim_queue_len <= 0:
        return False
    return (thief_rel_rate >= STEAL_RATE_FLOOR
            or victim_queue_len > STEAL_QUEUE_DEPTH)


def pick_victim(queue_lens: Sequence[int]) -> int:
    """Index of the busiest victim queue (ties -> lowest index, matching
    the simulator's ``max(range(n), key=len)`` from day one)."""
    return max(range(len(queue_lens)), key=lambda i: queue_lens[i])


def lpt_pick(eligible: Sequence[int], loads: Sequence[float],
             costs: Sequence[float]) -> int:
    """LPT-style seed (§3.1.1): among ``eligible`` queue indices, the one
    with the smallest projected finish time ``loads[i] + costs[i]`` (ties ->
    lowest index).  The live runtime seeds submissions with this, and graph
    nodes becoming ready mid-run re-enter the SAME decision, so a DAG
    successor is placed exactly as a fresh submission would be."""
    return min(eligible, key=lambda i: loads[i] + costs[i])
