"""Synergy schedulers: static mapping (SF/SC), work stealing, and the
discrete-event runtime simulator used to reproduce the paper's results
(Fig 9, 11-14, Tables 5/6).

Three scheduling policies from the paper (§3.1.3, §4.3):

  * SF  — static-mapping + fixed-architecture: CONV layers statically
          assigned to the fixed two-cluster config by workload.
  * SC  — static-mapping + custom-architecture: exhaustive search over
          cluster partitions per network (Table 5), still static.
  * WS  — Synergy: same fixed clusters as SF, plus the thief thread
          (manager / idle-book / stealer) moving jobs from busy to idle
          clusters at job granularity.

The simulator is event-driven and models: the two ARM cores as a shared CPU
pool (im2col, pooling, activation, FC, normalization), per-cluster job
queues, per-accelerator service times from the engine cost models in the
``repro_torch.engines`` registry (each ``Accelerator`` is a thin view over its
kind's registered engine), bounded frames-in-flight (the mailbox pipeline
of §3.1), and the stealing protocol.  It is also the planning oracle for
the TPU between-step rebalancer (``lpt_plan`` / ``rebalance``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Callable, Sequence

from repro_torch.soc.policy import pick_victim, should_steal

from .clusters import (Accelerator, Cluster, arm_cost, cluster_partitions,
                       default_synergy_clusters)
from .job import Job, JobSet

__all__ = [
    "SimLayer", "SimNet", "SimResult", "simulate", "single_thread_latency",
    "sf_layer_map", "search_sc", "lpt_plan", "rebalance",
]


# ---------------------------------------------------------------------------
# Network description for the runtime simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimLayer:
    """One pipeline stage. ``kind``: 'conv' (accelerated) or 'cpu'."""

    name: str
    kind: str
    jobset: JobSet | None = None   # conv only: per-frame tile jobs
    im2col_bytes: int = 0          # conv only: CPU-side layout transform
    cpu_ops: int = 0               # cpu only: pooling/act/fc op count

    def cpu_time(self) -> float:
        cpu = arm_cost()
        if self.kind == "conv":
            return self.im2col_bytes / cpu.bytes_per_s
        return self.cpu_ops / cpu.ops_per_s


@dataclasses.dataclass(frozen=True)
class SimNet:
    name: str
    layers: tuple[SimLayer, ...]

    @property
    def conv_layers(self) -> list[SimLayer]:
        return [l for l in self.layers if l.kind == "conv"]


@dataclasses.dataclass
class SimResult:
    fps: float
    latency_s: float              # mean steady-state per-frame latency
    utilization: float            # accelerator busy fraction (Table 6 metric)
    per_cluster_busy: dict[str, float]
    per_cluster_runtime: dict[str, float]  # Fig 14 metric: busy s/frame
    makespan_s: float


# ---------------------------------------------------------------------------
# Static layer->cluster mapping (SF) and the SC search
# ---------------------------------------------------------------------------

def sf_layer_map(net: SimNet, clusters: Sequence[Cluster]) -> dict[str, int]:
    """Greedy workload-balanced static map: heavier CONV layers to more
    powerful clusters (§3.1.1 'Mapping of CONV layers and clusters is
    decided by the number of jobs a CONV layer has')."""
    loads = [0.0] * len(clusters)
    mapping: dict[str, int] = {}
    convs = sorted(net.conv_layers, key=lambda l: -l.jobset.total_macs)
    for layer in convs:
        # assign to the cluster minimizing projected finish time
        best = min(range(len(clusters)),
                   key=lambda c: (loads[c] + layer.jobset.total_macs)
                   / max(clusters[c].throughput, 1e-9))
        loads[best] += layer.jobset.total_macs
        mapping[layer.name] = best
    return mapping


def search_sc(net: SimNet, frames: int = 64) -> tuple[list[Cluster], dict[str, int], "SimResult"]:
    """SC: exhaustive cluster-partition search per network (paper Table 5)."""
    best = None
    for clusters in cluster_partitions():
        mapping = sf_layer_map(net, clusters)
        res = simulate(net, clusters, policy="sf", mapping=mapping,
                       frames=frames)
        if best is None or res.fps > best[2].fps:
            best = (clusters, mapping, res)
    return best


# ---------------------------------------------------------------------------
# Event-driven simulator
# ---------------------------------------------------------------------------

_CPU_CORES = 2  # dual-core ARM A9


def simulate(net: SimNet,
             clusters: Sequence[Cluster] | None = None,
             *,
             policy: str = "ws",          # 'ws' | 'sf'
             mapping: dict[str, int] | None = None,
             frames: int = 64,
             inflight: int = 8,
             pipelined: bool = True,
             warmup_frames: int = 8) -> SimResult:
    """Run the Synergy runtime simulator for ``frames`` input frames."""
    clusters = list(clusters) if clusters is not None else default_synergy_clusters()
    if mapping is None:
        mapping = sf_layer_map(net, clusters)

    layers = net.layers
    n_layers = len(layers)
    accs: list[tuple[int, Accelerator]] = []   # (cluster_idx, accelerator)
    for ci, cl in enumerate(clusters):
        for a in cl.accelerators:
            accs.append((ci, a))

    # --- state ------------------------------------------------------------
    queues: list[deque] = [deque() for _ in clusters]   # per-cluster job queues
    acc_free = [True] * len(accs)
    acc_busy_time = [0.0] * len(accs)
    cpu_free = _CPU_CORES
    cpu_queue: deque = deque()           # (duration, callback)
    remaining: dict[tuple[int, int], int] = {}   # (layer, frame) -> jobs left
    frame_admit_t: dict[int, float] = {}
    frame_done_t: dict[int, float] = {}
    events: list = []                    # (time, seq, fn)
    seq = itertools.count()
    now = 0.0

    def push(t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(events, (t, next(seq), fn))

    # --- CPU pool -----------------------------------------------------------
    def cpu_submit(duration: float, done_cb: Callable[[], None]) -> None:
        nonlocal cpu_free
        if cpu_free > 0:
            cpu_free -= 1
            push(now + duration, lambda: _cpu_done(done_cb))
        else:
            cpu_queue.append((duration, done_cb))

    def _cpu_done(done_cb: Callable[[], None]) -> None:
        nonlocal cpu_free
        if cpu_queue:
            duration, cb = cpu_queue.popleft()
            push(now + duration, lambda: _cpu_done(cb))
        else:
            cpu_free += 1
        done_cb()

    # --- accelerators + work stealing --------------------------------------
    def try_dispatch(acc_idx: int) -> None:
        ci, acc = accs[acc_idx]
        if not acc_free[acc_idx]:
            return
        job = None
        if queues[ci]:
            job = queues[ci].popleft()
        elif policy == "ws":
            # thief thread: manager sees this cluster idle; stealer takes a
            # job from the busiest victim queue (job-level granularity —
            # §4.3 "work-stealing ... at the granularity of job-level").
            # The decision is the SHARED policy in repro_torch.soc.policy — the
            # live SynergyRuntime and SimRuntime apply the same tail guard.
            victim = pick_victim([len(q) for q in queues])
            if should_steal(acc.rel_rate, len(queues[victim])):
                job = queues[victim].popleft()
        if job is None:
            return
        layer_idx, frame, macs = job
        dt = acc.job_time(macs)
        acc_free[acc_idx] = False
        acc_busy_time[acc_idx] += dt
        push(now + dt, lambda: _acc_done(acc_idx, layer_idx, frame))

    def _acc_done(acc_idx: int, layer_idx: int, frame: int) -> None:
        acc_free[acc_idx] = True
        remaining[(layer_idx, frame)] -= 1
        if remaining[(layer_idx, frame)] == 0:
            frame_at(layer_idx + 1, frame)
        try_dispatch(acc_idx)

    def kick_cluster(ci: int) -> None:
        for ai, (c, _) in enumerate(accs):
            if c == ci and acc_free[ai]:
                try_dispatch(ai)
        if policy == "ws":
            for ai in range(len(accs)):
                if acc_free[ai]:
                    try_dispatch(ai)

    # --- pipeline flow -------------------------------------------------------
    def frame_at(layer_idx: int, frame: int) -> None:
        if layer_idx == n_layers:
            frame_done_t[frame] = now
            nxt = max(frame_admit_t) + 1 if frame_admit_t else 0
            if nxt < frames and len(frame_admit_t) - len(frame_done_t) < inflight:
                admit(nxt)
            return
        layer = layers[layer_idx]
        if layer.kind == "conv":
            def after_im2col(li=layer_idx, f=frame, lay=layer):
                js = lay.jobset
                n_jobs = js.num_jobs
                remaining[(li, f)] = n_jobs
                ci = mapping[lay.name]
                per_job_macs = js.total_macs // n_jobs
                for _ in range(n_jobs):
                    queues[ci].append((li, f, per_job_macs))
                kick_cluster(ci)
            cpu_submit(layer.cpu_time(), after_im2col)
        else:
            cpu_submit(layer.cpu_time(), lambda li=layer_idx, f=frame: frame_at(li + 1, f))

    def admit(frame: int) -> None:
        frame_admit_t[frame] = now
        frame_at(0, frame)

    # --- run -----------------------------------------------------------------
    init = inflight if pipelined else 1
    for f in range(min(init, frames)):
        admit(f)
    # sequential (non-pipelined) mode admits the next frame on completion,
    # which frame_at() already does; with inflight=1 that's sequential.
    if not pipelined:
        inflight = 1

    while events and len(frame_done_t) < frames:
        now, _, fn = heapq.heappop(events)
        fn()

    makespan = now
    done = sorted(frame_done_t)
    # steady-state window: skip at least the initial admission burst
    # (`inflight` frames complete in a bunch) plus the warmup allowance —
    # otherwise short runs overestimate fps beyond the physical pool rate.
    w = min(max(warmup_frames, inflight), max(0, len(done) - 2))
    t0 = frame_done_t[done[w]] if len(done) > w else 0.0
    steady = len(done) - 1 - w
    fps = steady / (makespan - t0) if steady > 0 and makespan > t0 else (
        len(done) / makespan if makespan > 0 else 0.0)
    lat = sum(frame_done_t[f] - frame_admit_t[f] for f in done[w:]) / max(1, len(done) - w)

    per_cluster_busy: dict[str, float] = {}
    per_cluster_runtime: dict[str, float] = {}
    util_num = util_den = 0.0
    i = 0
    for ci, cl in enumerate(clusters):
        busy = sum(acc_busy_time[i + j] for j in range(len(cl)))
        per_cluster_busy[cl.name] = busy / (len(cl) * makespan) if makespan else 0.0
        per_cluster_runtime[cl.name] = busy / max(1, len(done))
        util_num += busy
        util_den += len(cl) * makespan
        i += len(cl)
    return SimResult(fps=fps, latency_s=lat,
                     utilization=util_num / util_den if util_den else 0.0,
                     per_cluster_busy=per_cluster_busy,
                     per_cluster_runtime=per_cluster_runtime,
                     makespan_s=makespan)


# ---------------------------------------------------------------------------
# Software-only baselines
# ---------------------------------------------------------------------------

def single_thread_latency(net: SimNet) -> float:
    """Original Darknet: one ARM core does everything (paper's baseline)."""
    t = 0.0
    cpu = arm_cost()
    for layer in net.layers:
        t += layer.cpu_time()
        if layer.kind == "conv":
            t += layer.jobset.useful_macs / cpu.macs_per_s
    return t


# ---------------------------------------------------------------------------
# Production planner: the work-stealing insight as a between-step rebalancer
# ---------------------------------------------------------------------------

def lpt_plan(jobsets: Sequence[JobSet], clusters: Sequence[Cluster]) -> list[list[int]]:
    """Longest-processing-time assignment of job *sets* to clusters,
    proportional to cluster throughput — the static seed plan (SF analog).
    Returns, per cluster, the list of jobset indices."""
    order = sorted(range(len(jobsets)), key=lambda i: -jobsets[i].total_macs)
    loads = [0.0] * len(clusters)
    plan: list[list[int]] = [[] for _ in clusters]
    for i in order:
        c = min(range(len(clusters)),
                key=lambda ci: (loads[ci] + jobsets[i].total_macs)
                / max(clusters[ci].throughput, 1e-9))
        loads[c] += jobsets[i].total_macs
        plan[c].append(i)
    return plan


def rebalance(shares: Sequence[float], measured_s: Sequence[float],
              ema: float = 0.5) -> list[float]:
    """Between-step work stealing for SPMD: given the current work shares and
    the measured per-cluster step times, shift share from slow to fast
    clusters so projected times equalize.  EMA damps oscillation.

    shares sum to 1; measured_s are wall times of the last step."""
    rates = [s / t if t > 0 else 0.0 for s, t in zip(shares, measured_s)]
    total_rate = sum(rates)
    if total_rate <= 0:
        return list(shares)
    target = [r / total_rate for r in rates]
    out = [(1 - ema) * s + ema * t for s, t in zip(shares, target)]
    norm = sum(out)
    return [s / norm for s in out]
