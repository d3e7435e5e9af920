"""Straggler mitigation = the Synergy work-stealing insight at pod scale.

On the Zynq SoC, Synergy's thief thread moves tile jobs from busy clusters
to idle ones at runtime (paper §3.1.3).  A lockstep SPMD program cannot
steal mid-step, but the SAME job-granularity rebalancing applies BETWEEN
steps: device groups ("clusters") that consistently finish late (thermal
throttling, degraded ICI, a slow host) should own a smaller share of the
tile-job space next step.

``StragglerRebalancer`` keeps an EMA of per-cluster step times and re-plans
the work shares with :func:`repro_torch.core.scheduler.rebalance` — the
identical math the DES validates against the paper's Figure 13/14.  Used
by the serving engine (prefill/decode job mix across replica groups) and
by microbatch-level DP splits.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler import rebalance

__all__ = ["StragglerRebalancer"]


@dataclasses.dataclass
class StragglerRebalancer:
    n_clusters: int
    ema: float = 0.3
    min_share: float = 0.02

    def __post_init__(self):
        self.shares = [1.0 / self.n_clusters] * self.n_clusters
        self.ema_times = [0.0] * self.n_clusters
        self.history: list[list[float]] = []

    def observe(self, step_times: list[float]) -> list[float]:
        """Feed measured per-cluster wall times; returns new shares."""
        for i, t in enumerate(step_times):
            self.ema_times[i] = (self.ema * t + (1 - self.ema) *
                                 (self.ema_times[i] or t))
        new = rebalance(self.shares, self.ema_times, ema=self.ema)
        new = [max(self.min_share, s) for s in new]
        total = sum(new)
        self.shares = [s / total for s in new]
        self.history.append(list(self.shares))
        return self.shares

    def split_jobs(self, n_jobs: int) -> list[int]:
        """Integer job counts per cluster matching current shares."""
        counts = [int(s * n_jobs) for s in self.shares]
        rem = n_jobs - sum(counts)
        order = sorted(range(self.n_clusters),
                       key=lambda i: -(self.shares[i] * n_jobs
                                       - counts[i]))
        for i in range(rem):
            counts[order[i % self.n_clusters]] += 1
        return counts
