"""Heterogeneous accelerator clusters (paper §3.1.1 "Accelerator Clusters").

The paper's prototype uses a fixed, network-agnostic accelerator set on the
Zynq XC7Z020: 6 fast FPGA PEs (F-PE), 2 slow PEs (S-PE) and 2 NEON cores,
grouped into clusters with private job queues.

Each :class:`Accelerator` is a THIN VIEW over the engine registry
(:mod:`repro_torch.engines`): its kind names a registered simulated engine
(``F-PE`` / ``S-PE`` / ``NEON`` / ``ARM``) whose :class:`CostModel` carries
the calibrated rates — see ``repro_torch.engines.sim`` for the calibration notes.
Accelerator views read the registry LIVE — re-registering a kind's engine
re-rates every accelerator, cluster, simulator run, and planner at once.
The module-level rate constants are import-time snapshots kept only for
backward compatibility; new code should go through ``Accelerator.cost`` /
``arm_cost()``.

At pod scale the same abstraction describes *device groups* of a TPU mesh
(possibly heterogeneous across generations or degraded/straggler nodes); the
between-step rebalancer in ``repro_torch.runtime.straggler`` consumes the same
``Cluster`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.engines import CostModel, find_engine, get_engine

__all__ = [
    "Accelerator", "Cluster", "F_PE", "S_PE", "NEON",
    "default_synergy_clusters", "make_accelerators", "arm_cost",
    "CPU_CONV_MACS_PER_S", "CPU_OTHER_OPS_PER_S", "CPU_COPY_BYTES_PER_S",
    "JOB_DISPATCH_S", "F_PE_MACS_PER_S",
]


def arm_cost() -> CostModel:
    """The host-CPU cost model (im2col / pooling / act / fc stages)."""
    return get_engine("ARM").cost


def _kind_cost(kind: str) -> CostModel:
    return get_engine(kind).cost


# --- registry-derived aliases (the single source is repro_torch.engines.sim) -----
F_PE_MACS_PER_S = _kind_cost("F-PE").macs_per_s
JOB_DISPATCH_S = _kind_cost("F-PE").dispatch_s
CPU_CONV_MACS_PER_S = arm_cost().macs_per_s
CPU_OTHER_OPS_PER_S = arm_cost().ops_per_s
CPU_COPY_BYTES_PER_S = arm_cost().bytes_per_s


def _rel_rate(kind: str) -> float:
    """Registered kind rate expressed in F-PE units (live registry read)."""
    eng, base = find_engine(kind), find_engine("F-PE")
    if eng is None or base is None:
        return 1.0
    return eng.cost.macs_per_s / base.cost.macs_per_s


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """One PE/NEON — a THIN VIEW over the engine registry.

    ``rate`` (F-PE units; F-PE == 1.0) and ``dispatch_s`` default to None,
    meaning "track the registered engine of my ``kind`` live" — so
    re-registering a kind's engine re-rates every existing Accelerator,
    cluster, and planner at once.  Explicit values pin a custom rate
    (degraded nodes, hypothetical hardware)."""

    name: str
    kind: str          # 'F-PE' | 'S-PE' | 'NEON' | 'TPU-slice' | engine name
    rate: float | None = None        # relative to F-PE; None = registry
    dispatch_s: float | None = None  # None = kind engine's dispatch

    @property
    def rel_rate(self) -> float:
        """Throughput in F-PE units (LPT planner / steal-guard metric)."""
        return self.rate if self.rate is not None else _rel_rate(self.kind)

    @property
    def cost(self) -> CostModel:
        """This accelerator's cost model view over the registry."""
        eng = find_engine(self.kind)
        if self.rate is None and eng is not None:
            base = eng.cost
        else:
            fpe = find_engine("F-PE")
            per_fpe = fpe.cost.macs_per_s if fpe is not None else F_PE_MACS_PER_S
            base = CostModel(macs_per_s=self.rel_rate * per_fpe,
                             dispatch_s=(eng.cost.dispatch_s if eng is not None
                                         else JOB_DISPATCH_S))
        if self.dispatch_s is not None:
            base = dataclasses.replace(base, dispatch_s=self.dispatch_s)
        return base

    @property
    def macs_per_s(self) -> float:
        return self.cost.macs_per_s

    def job_time(self, job_macs: int) -> float:
        return self.cost.job_time(job_macs)


def F_PE(i: int) -> Accelerator:
    return Accelerator(f"F-PE{i}", "F-PE")


def S_PE(i: int) -> Accelerator:
    return Accelerator(f"S-PE{i}", "S-PE")


def NEON(i: int) -> Accelerator:
    return Accelerator(f"NEON{i}", "NEON")


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A named group of accelerators with a private job queue (§3.1.1)."""

    name: str
    accelerators: tuple[Accelerator, ...]

    @property
    def throughput(self) -> float:
        """Aggregate rate in F-PE units (used by the LPT planner)."""
        return sum(a.rel_rate for a in self.accelerators)

    def __len__(self) -> int:
        return len(self.accelerators)


def make_accelerators(n_fpe: int, n_spe: int, n_neon: int) -> list[Accelerator]:
    return ([F_PE(i) for i in range(n_fpe)]
            + [S_PE(i) for i in range(n_spe)]
            + [NEON(i) for i in range(n_neon)])


def default_synergy_clusters() -> list[Cluster]:
    """The paper's fixed two-cluster config used across ALL benchmarks:
    Cluster-0: 2 NEONs + 2 S-PE;  Cluster-1: 6 F-PE  (§4, 'Synergy uses two
    clusters ... across all benchmarks')."""
    c0 = Cluster("Cluster-0", tuple([NEON(0), NEON(1), S_PE(0), S_PE(1)]))
    c1 = Cluster("Cluster-1", tuple(F_PE(i) for i in range(6)))
    return [c0, c1]


def cluster_partitions(n_fpe: int = 6, n_spe: int = 2, n_neon: int = 2):
    """Enumerate all two-cluster splits of the accelerator pool — the SC
    (static-custom) design space the paper searches (Table 5 footnote: any
    number of clusters; two suffices for these nets)."""
    for f0 in range(n_fpe + 1):
        for s0 in range(n_spe + 1):
            for n0 in range(n_neon + 1):
                a0 = make_accelerators(f0, s0, n0)
                a1 = ([F_PE(i + f0) for i in range(n_fpe - f0)]
                      + [S_PE(i + s0) for i in range(n_spe - s0)]
                      + [NEON(i + n0) for i in range(n_neon - n0)])
                if not a0 or not a1:
                    continue
                yield [Cluster("Cluster-0", tuple(a0)),
                       Cluster("Cluster-1", tuple(a1))]
