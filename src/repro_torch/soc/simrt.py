"""SimRuntime — the live runtime's scheduling loop in virtual time.

Conformance mode for :class:`repro_torch.soc.SynergyRuntime`: identical queues,
identical seeding, and the SAME :func:`repro_torch.soc.policy.should_steal` /
:func:`~repro_torch.soc.policy.pick_victim` the discrete-event simulator uses —
but service times come from the engine cost models instead of wall clock,
so steal decisions are deterministic and can be checked against
``repro_torch.core.scheduler.simulate(policy="ws")`` for identical cost models.

Event semantics mirror the DES: jobs are seeded onto one queue (the static
mapping), every free engine is kicked in pool order, and on each completion
the finishing engine pops its own queue or steals from the busiest victim
under the tail guard.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional, Sequence, Union

from repro_torch.engines.base import Engine
from repro_torch.engines.registry import get_engine

from .policy import lpt_pick, pick_victim, should_steal
from .qos_policy import (NEUTRAL_TAG, effective_deadline, qos_victim,
                         queue_insert_index)

__all__ = ["SimRuntime", "SimRuntimeResult", "SimGraphResult",
           "SimQosResult", "SimFaultResult"]


@dataclasses.dataclass
class SimRuntimeResult:
    makespan_s: float
    per_engine_jobs: dict[str, int]
    per_engine_busy: dict[str, float]
    per_engine_steals: dict[str, int]

    @property
    def total_steals(self) -> int:
        return sum(self.per_engine_steals.values())

    @property
    def aggregate_busy_fraction(self) -> float:
        """Table-6 analog: total busy over pool-size x makespan."""
        if self.makespan_s <= 0:
            return 0.0
        n = len(self.per_engine_busy)
        return sum(self.per_engine_busy.values()) / (n * self.makespan_s)


@dataclasses.dataclass
class SimGraphResult(SimRuntimeResult):
    """One graph run in virtual time: per-node completion stamps on top of
    the usual per-engine accounting."""

    node_finish_s: tuple[float, ...] = ()


@dataclasses.dataclass
class SimFaultResult(SimRuntimeResult):
    """One fault-schedule run in virtual time: the usual per-engine
    accounting plus the recovery audit — retries consumed, workers
    lost, orphans re-seeded, and every injected ``(engine, kind, call)``
    in virtual order.  ``completed_jobs`` counts jobs whose unit
    ultimately completed (the exactly-once conformance surface: it must
    equal the jobset's job count for any retryable plan)."""

    retries: int = 0
    worker_deaths: int = 0
    orphan_reseeds: int = 0
    exhausted: int = 0
    injected: tuple = ()
    completed_jobs: int = 0


@dataclasses.dataclass
class SimQosResult(SimRuntimeResult):
    """A QoS-tagged batch in virtual time: per-submission finish stamps,
    deadline verdicts, and the seed map (engine name per unit, in
    submission order) — the conformance surface against the live
    :meth:`SynergyRuntime._seed_locked`."""

    submission_finish_s: tuple[float, ...] = ()
    deadline_met: tuple[bool, ...] = ()
    seed_map: tuple[tuple[str, ...], ...] = ()


class SimRuntime:
    """Virtual-time work-stealing executor over engine cost models.

    ``tracer=Tracer(...)`` records the SAME event schema the live
    runtime emits (seed/enqueue/dequeue, panel spans, steals, graph node
    transitions) with VIRTUAL timestamps, so a sim trace diffs directly
    against a live trace of the same workload.  Unlike the live runtime
    the sim never falls back to the process-default tracer — a
    ``--trace``'d benchmark must not interleave virtual stamps into its
    wall-clock timeline."""

    def __init__(self, engines: Sequence[Union[str, Engine]], *,
                 tracer=None):
        self.engines = [get_engine(e) if isinstance(e, str) else e
                        for e in engines]
        if not self.engines:
            raise ValueError("SimRuntime needs at least one engine")
        self.tracer = tracer

    def run(self, jobset, *, affinity: Optional[str] = None,
            granularity: str = "job") -> SimRuntimeResult:
        """Execute one JobSet in virtual time.  ``affinity`` seeds every
        job on that engine's queue (the live runtime's queue-affinity hint;
        default: first engine, matching the DES static map of one layer to
        one cluster); stealing distributes from there."""
        j = next(jobset.jobs()) if jobset.num_jobs else None
        if j is None:
            zero = {e.name: 0 for e in self.engines}
            return SimRuntimeResult(0.0, dict(zero),
                                    {e.name: 0.0 for e in self.engines},
                                    dict(zero))
        if granularity == "job":
            units = [(1, j.macs, j.bytes_moved)] * jobset.num_jobs
        else:
            gm, gn = jobset.grid
            units = [(gn, j.macs, j.bytes_moved)] * gm

        names = [e.name for e in self.engines]
        queues: list[list] = [[] for _ in self.engines]
        home = names.index(affinity) if affinity in names else 0
        queues[home].extend(units)

        tr = self.tracer
        if tr is not None:
            tr.emit("seed", "manager", ts=0.0, runtime="sim",
                    n_jobs=len(units), affinity=affinity)
            for u in units:
                tr.emit("enqueue", names[home], ts=0.0,
                        jobset=jobset.name, n_jobs=u[0], priority=0)

        rates = [e.cost.macs_per_s for e in self.engines]
        fastest = max(rates)
        busy = [0.0] * len(self.engines)
        jobs_run = [0] * len(self.engines)
        steals = [0] * len(self.engines)
        free = [True] * len(self.engines)

        events: list = []
        seq = itertools.count()
        now = 0.0

        def unit_time(i: int, unit) -> float:
            n_jobs, macs, nbytes = unit
            return n_jobs * self.engines[i].cost.job_time(macs, nbytes)

        def try_dispatch(i: int) -> None:
            if not free[i]:
                return
            unit = None
            stolen = False
            victim = None
            if queues[i]:
                unit = queues[i].pop(0)
            else:
                lens = [len(q) for q in queues]
                if any(lens):
                    v = pick_victim(lens)
                    if v != i and should_steal(rates[i] / fastest, lens[v]):
                        unit = queues[v].pop()     # steal from the tail
                        stolen = True
                        victim = names[v]
            if unit is None:
                return
            dt = unit_time(i, unit)
            free[i] = False
            busy[i] += dt
            jobs_run[i] += unit[0]
            steals[i] += int(stolen)
            if tr is not None:
                if stolen:
                    tr.emit("steal", names[i], ts=now, victim=victim,
                            jobset=jobset.name, priority=0, probe=False)
                else:
                    tr.emit("dequeue", names[i], ts=now,
                            jobset=jobset.name, n_jobs=unit[0])
                tr.span("panel", names[i], now, dt, jobset=jobset.name,
                        n_jobs=unit[0], stolen=stolen, priority=0)
            heapq.heappush(events, (now + dt, next(seq), i))

        def kick_all() -> None:
            for i in range(len(self.engines)):
                try_dispatch(i)

        kick_all()
        while events:
            now, _, i = heapq.heappop(events)
            free[i] = True
            try_dispatch(i)

        return SimRuntimeResult(
            makespan_s=now,
            per_engine_jobs=dict(zip(names, jobs_run)),
            per_engine_busy=dict(zip(names, busy)),
            per_engine_steals=dict(zip(names, steals)))

    def run_faults(self, jobset, plan, retry, *,
                   affinity: Optional[str] = None,
                   granularity: str = "job") -> SimFaultResult:
        """Execute one JobSet under a :class:`~repro_torch.soc.faults.FaultPlan`
        and :class:`~repro_torch.soc.faults.RetryPolicy` in VIRTUAL time — the
        conformance twin of the live runtime's fault recovery.

        Modeled kinds: ``raise``/``corrupt`` (the unit fails — instantly
        for a raise, after its full service time for corruption, matching
        where the live integrity guard detects it — and re-seeds onto an
        eligible engine avoiding the ones it failed on), ``slowdown``
        (service time × the ramping factor), and ``die`` (the engine
        leaves the pool at the virtual fault instant; its in-flight unit
        and queue re-seed onto the survivors).  ``stall``/``drop`` are
        wall-clock phenomena (the live stall sweep races real threads)
        and raise ``ValueError`` here.

        Emits the SAME event kinds and tag keys the live runtime emits
        (``fault_injected``/``panel_retry``/``worker_death``/
        ``orphan_reseed``) with virtual stamps, so a sim trace schema-
        checks against a live trace of the same plan."""
        for s in plan.specs:
            if s.kind in ("stall", "drop"):
                raise ValueError(
                    f"run_faults cannot model wall-clock kind {s.kind!r}")
        j = next(jobset.jobs()) if jobset.num_jobs else None
        names = [e.name for e in self.engines]
        if j is None:
            zero = {n: 0 for n in names}
            return SimFaultResult(0.0, dict(zero),
                                  {n: 0.0 for n in names}, dict(zero))
        if granularity == "job":
            per = [(1, j.macs, j.bytes_moved)] * jobset.num_jobs
        else:
            gm, gn = jobset.grid
            per = [(gn, j.macs, j.bytes_moved)] * gm
        # mutable unit records: retry bookkeeping rides on the unit
        units = [{"n_jobs": n_jobs, "macs": macs, "nbytes": nbytes,
                  "attempts": 0, "failed": []}
                 for n_jobs, macs, nbytes in per]

        queues: list[list] = [[] for _ in self.engines]
        home = names.index(affinity) if affinity in names else 0
        queues[home].extend(units)

        tr = self.tracer
        if tr is not None:
            tr.emit("seed", "manager", ts=0.0, runtime="sim",
                    n_jobs=len(units), affinity=affinity)
            for u in units:
                tr.emit("enqueue", names[home], ts=0.0,
                        jobset=jobset.name, n_jobs=u["n_jobs"], priority=0)

        rates = [e.cost.macs_per_s for e in self.engines]
        busy = [0.0] * len(self.engines)
        jobs_run = [0] * len(self.engines)
        steals = [0] * len(self.engines)
        free = [True] * len(self.engines)
        alive = [True] * len(self.engines)
        calls = [0] * len(self.engines)
        specs = [plan.for_engine(n) for n in names]

        n_retries = deaths = reseeds = exhausted = 0
        injected: list[tuple[str, str, int]] = []
        completed_jobs = 0

        events: list = []
        seq = itertools.count()
        now = 0.0

        def unit_time(i: int, u: dict) -> float:
            return u["n_jobs"] * self.engines[i].cost.job_time(u["macs"],
                                                               u["nbytes"])

        def queue_load(i: int) -> float:
            return sum(unit_time(i, u) for u in queues[i])

        def reseed(us: list[dict], source: str) -> None:
            """LPT the orphaned/retried units back onto the live pool,
            honoring ``avoid_failed_engine`` where an alternative
            exists."""
            for u in us:
                elig = [i for i in range(len(names)) if alive[i]]
                if retry.avoid_failed_engine:
                    avoided = [i for i in elig
                               if names[i] not in u["failed"]]
                    if avoided:
                        elig = avoided
                loads = [queue_load(i) for i in range(len(names))]
                costs = [unit_time(i, u) for i in range(len(names))]
                ai = lpt_pick(elig, loads, costs)
                queues[ai].append(u)
                if tr is not None:
                    tr.emit("enqueue", names[ai], ts=now,
                            jobset=jobset.name, n_jobs=u["n_jobs"],
                            priority=0)

        def try_dispatch(i: int) -> None:
            nonlocal n_retries, deaths, reseeds
            if not free[i] or not alive[i]:
                return
            unit = None
            stolen = False
            victim = None
            if queues[i]:
                unit = queues[i].pop(0)
            else:
                lens = [len(q) for q in queues]
                if any(lens):
                    v = pick_victim(lens)
                    fastest = max(r for r, a in zip(rates, alive) if a)
                    if v != i and should_steal(rates[i] / fastest,
                                               lens[v]):
                        unit = queues[v].pop()     # steal from the tail
                        stolen = True
                        victim = names[v]
            if unit is None:
                return
            call = calls[i]
            calls[i] += 1
            spec = next((s for s in specs[i] if s.hits(call)), None)
            if spec is not None:
                injected.append((names[i], spec.kind, call))
                if tr is not None:
                    tr.emit("fault_injected", names[i], ts=now,
                            fault=spec.kind, call=call, at_call=spec.at_call)
            if spec is not None and spec.kind == "die":
                # the engine leaves the pool NOW: its in-flight unit and
                # queued units re-seed onto the survivors
                alive[i] = False
                free[i] = False
                unit["failed"].append(names[i])
                orphans = [unit] + queues[i]
                queues[i] = []
                deaths += 1
                reseeds += len(orphans)
                if tr is not None:
                    tr.emit("worker_death", names[i], ts=now,
                            runtime="sim", queued=len(orphans) - 1,
                            in_flight=1)
                    tr.emit("orphan_reseed", names[i], ts=now,
                            runtime="sim", n_jobs=len(orphans))
                reseed(orphans, names[i])
                for k in range(len(names)):
                    try_dispatch(k)
                return
            dt = unit_time(i, unit)
            err = None
            if spec is not None:
                if spec.kind == "raise":
                    err, dt = "InjectedFault", 0.0
                elif spec.kind == "corrupt":
                    # detected by the integrity guard AFTER the compute
                    err = "CorruptOutput"
                elif spec.kind == "slowdown":
                    dt *= spec.factor + spec.ramp * (call - spec.at_call)
            free[i] = False
            busy[i] += dt
            jobs_run[i] += unit["n_jobs"]
            steals[i] += int(stolen)
            if tr is not None:
                if stolen:
                    tr.emit("steal", names[i], ts=now, victim=victim,
                            jobset=jobset.name, priority=0, probe=False)
                else:
                    tr.emit("dequeue", names[i], ts=now,
                            jobset=jobset.name, n_jobs=unit["n_jobs"])
                tags = {"jobset": jobset.name, "n_jobs": unit["n_jobs"],
                        "stolen": stolen, "priority": 0}
                if err is not None:
                    tags["err"] = err
                tr.span("panel", names[i], now, dt, **tags)
            heapq.heappush(events, (now + dt, next(seq), i, unit, err))

        for i in range(len(self.engines)):
            try_dispatch(i)
        while events:
            now, _, i, unit, err = heapq.heappop(events)
            if alive[i]:
                free[i] = True
            if err is not None:
                unit["attempts"] += 1
                if names[i] not in unit["failed"]:
                    unit["failed"].append(names[i])
                if unit["attempts"] >= retry.max_attempts:
                    exhausted += 1       # submission fails; unit is done
                else:
                    n_retries += 1
                    if tr is not None:
                        tr.emit("panel_retry", names[i], ts=now,
                                jobset=jobset.name,
                                attempt=unit["attempts"], err=err)
                    reseed([unit], names[i])
            else:
                completed_jobs += unit["n_jobs"]
            for k in range(len(names)):
                try_dispatch(k)

        return SimFaultResult(
            makespan_s=now,
            per_engine_jobs=dict(zip(names, jobs_run)),
            per_engine_busy=dict(zip(names, busy)),
            per_engine_steals=dict(zip(names, steals)),
            retries=n_retries, worker_deaths=deaths,
            orphan_reseeds=reseeds, exhausted=exhausted,
            injected=tuple(injected), completed_jobs=completed_jobs)

    def run_qos(self, submissions, *, quarantined: Sequence[str] = (),
                granularity: str = "job") -> SimQosResult:
        """Execute a batch of QoS-tagged submissions in virtual time — the
        conformance twin of the live runtime's deadline seeding and
        quarantine exclusion.

        ``submissions``: sequence of ``(jobset, QosTag-or-None)`` pairs
        (one batched admission wave, like ``submit_many``).
        ``quarantined``: engine names currently quarantined — they take no
        seeds and no steals, and drop out of the best-rate/fastest
        denominators, exactly as in :meth:`SynergyRuntime._seed_locked`
        and ``_try_steal_locked`` (the sim models the quarantined steady
        state; probation probes are a wall-clock concern).

        The decisions are the SHARED pure functions —
        :func:`~repro_torch.soc.policy.lpt_pick` over deadline-ordered units,
        :func:`~repro_torch.soc.qos_policy.queue_insert_index` placement,
        :func:`~repro_torch.soc.qos_policy.qos_victim` +
        :func:`~repro_torch.soc.policy.should_steal` stealing — so an
        all-neutral batch reproduces :meth:`run` and the live runtime's
        trace decision-for-decision."""
        subs = [(js, tag or NEUTRAL_TAG) for js, tag in submissions]
        names = [e.name for e in self.engines]
        quar = [e.name in set(quarantined) for e in self.engines]
        if all(quar):
            raise ValueError("run_qos: every engine quarantined")
        rates = [e.cost.macs_per_s for e in self.engines]
        best_rate = max(r for r, q in zip(rates, quar) if not q)

        # one unit = (sub_id, unit_seq, priority, deadline_at, n_jobs,
        #             macs, nbytes); unit_seq keeps the seed order stable
        units: list[tuple] = []
        for sid, (js, tag) in enumerate(subs):
            j = next(js.jobs()) if js.num_jobs else None
            if j is None:
                continue
            if granularity == "job":
                per = [(1, j.macs, j.bytes_moved)] * js.num_jobs
            else:
                gm, gn = js.grid
                per = [(gn, j.macs, j.bytes_moved)] * gm
            base = len(units)
            units.extend((sid, base + u, tag.priority,
                          tag.deadline_at, *pu) for u, pu in enumerate(per))

        # deadline-aware seed order (the live _seed_order, verbatim logic)
        neutral = all(u[2] == 0 and u[3] == float("inf") for u in units)
        if not neutral:
            units = sorted(
                units, key=lambda u: (
                    -u[2],
                    effective_deadline(u[3], u[4] * u[5] / best_rate),
                    u[1]))

        # seed: LPT over non-quarantined engines, priority insertion
        queues: list[list] = [[] for _ in self.engines]
        loads = [0.0] * len(self.engines)
        seeded: dict[int, list[str]] = {sid: [] for sid in range(len(subs))}
        eligible = [i for i in range(len(self.engines)) if not quar[i]]
        tr = self.tracer
        if tr is not None:
            tr.emit("seed", "manager", ts=0.0, runtime="sim",
                    n_jobs=len(units), affinity=None)
        for u in units:
            sid, _, prio, _, n_jobs, macs, nbytes = u
            costs = [n_jobs * e.cost.job_time(macs, nbytes)
                     for e in self.engines]
            ai = lpt_pick(eligible, loads, costs)
            loads[ai] += costs[ai]
            q = queues[ai]
            if not q or prio <= q[-1][2]:
                q.append(u)
            else:
                q.insert(queue_insert_index([x[2] for x in q], prio), u)
            seeded[sid].append(names[ai])
            if tr is not None:
                tr.emit("enqueue", names[ai], ts=0.0,
                        jobset=subs[sid][0].name, n_jobs=n_jobs,
                        priority=prio)

        pending = [0] * len(subs)
        for u in units:
            pending[u[0]] += 1
        sub_finish = [0.0] * len(subs)

        fastest = max(r for r, q in zip(rates, quar) if not q)
        busy = [0.0] * len(self.engines)
        jobs_run = [0] * len(self.engines)
        steals = [0] * len(self.engines)
        free = [True] * len(self.engines)

        events: list = []
        seq = itertools.count()
        now = 0.0

        def try_dispatch(i: int) -> None:
            if not free[i]:
                return
            unit = None
            stolen = False
            victim = None
            if queues[i]:
                unit = queues[i].pop(0)
            elif not quar[i]:
                cand = [v for v in range(len(queues))
                        if v != i and queues[v]]
                if cand:
                    v = cand[qos_victim([queues[c][-1][2] for c in cand],
                                        [len(queues[c]) for c in cand])]
                    if should_steal(rates[i] / fastest, len(queues[v])):
                        unit = queues[v].pop()     # steal from the tail
                        stolen = True
                        victim = names[v]
            if unit is None:
                return
            sid, _, prio, _, n_jobs, macs, nbytes = unit
            dt = n_jobs * self.engines[i].cost.job_time(macs, nbytes)
            free[i] = False
            busy[i] += dt
            jobs_run[i] += n_jobs
            steals[i] += int(stolen)
            if tr is not None:
                jname = subs[sid][0].name
                if stolen:
                    tr.emit("steal", names[i], ts=now, victim=victim,
                            jobset=jname, priority=prio, probe=False)
                else:
                    tr.emit("dequeue", names[i], ts=now, jobset=jname,
                            n_jobs=n_jobs)
                tr.span("panel", names[i], now, dt, jobset=jname,
                        n_jobs=n_jobs, stolen=stolen, priority=prio)
            heapq.heappush(events, (now + dt, next(seq), i, sid))

        for i in range(len(self.engines)):
            try_dispatch(i)
        while events:
            now, _, i, sid = heapq.heappop(events)
            free[i] = True
            pending[sid] -= 1
            if pending[sid] == 0:
                sub_finish[sid] = now
            try_dispatch(i)

        return SimQosResult(
            makespan_s=now,
            per_engine_jobs=dict(zip(names, jobs_run)),
            per_engine_busy=dict(zip(names, busy)),
            per_engine_steals=dict(zip(names, steals)),
            submission_finish_s=tuple(sub_finish),
            deadline_met=tuple(f <= tag.deadline_at
                               for f, (_, tag) in zip(sub_finish, subs)),
            seed_map=tuple(tuple(seeded[sid])
                           for sid in range(len(subs))))

    def run_graph(self, jobsets, edges, *, affinity: Optional[str] = None,
                  granularity: str = "job") -> SimGraphResult:
        """Execute a DAG of accounting JobSets in virtual time — the
        conformance twin of :meth:`SynergyRuntime.submit_graph`.

        A node's units enter the home queue at the virtual instant its
        last predecessor's tail unit completes; every free engine is then
        kicked in pool order (exactly the state a fresh seed would see,
        since the finishing engine is free and all others drained
        earlier), so for a chain graph the trace is unit-for-unit
        identical to running the jobsets back-to-back through
        :meth:`run` — which is itself DES-conformant."""
        from .graph import validate_dag
        n = len(jobsets)
        succs, preds = validate_dag(n, edges)
        remaining = [len(p) for p in preds]

        def node_units(js) -> list:
            j = next(js.jobs()) if js.num_jobs else None
            if j is None:
                return []
            if granularity == "job":
                return [(1, j.macs, j.bytes_moved)] * js.num_jobs
            gm, gn = js.grid
            return [(gn, j.macs, j.bytes_moved)] * gm

        units = [node_units(js) for js in jobsets]
        pending = [len(u) for u in units]
        node_finish = [0.0] * n

        names = [e.name for e in self.engines]
        queues: list[list] = [[] for _ in self.engines]
        home = names.index(affinity) if affinity in names else 0

        rates = [e.cost.macs_per_s for e in self.engines]
        fastest = max(rates)
        busy = [0.0] * len(self.engines)
        jobs_run = [0] * len(self.engines)
        steals = [0] * len(self.engines)
        free = [True] * len(self.engines)

        events: list = []
        seq = itertools.count()
        now = 0.0

        tr = self.tracer

        def release(ready: list[int]) -> None:
            """Enqueue newly ready nodes at virtual time ``now``; empty
            nodes complete instantly and cascade."""
            while ready:
                nid = ready.pop(0)
                if tr is not None:
                    tr.emit("graph_node_ready", "graph", ts=now,
                            graph="sim-graph", node=nid,
                            node_name=jobsets[nid].name)
                if pending[nid] == 0:        # no units: done on release
                    node_finish[nid] = now
                    if tr is not None:
                        tr.emit("graph_node_done", "graph", ts=now,
                                graph="sim-graph", node=nid,
                                node_name=jobsets[nid].name, ok=True)
                    for s in succs[nid]:
                        remaining[s] -= 1
                        if remaining[s] == 0:
                            ready.append(s)
                    continue
                if tr is not None:
                    for u in units[nid]:
                        tr.emit("enqueue", names[home], ts=now,
                                jobset=jobsets[nid].name, n_jobs=u[0],
                                priority=0)
                queues[home].extend((nid,) + u for u in units[nid])

        def try_dispatch(i: int) -> None:
            if not free[i]:
                return
            unit = None
            stolen = False
            victim = None
            if queues[i]:
                unit = queues[i].pop(0)
            else:
                lens = [len(q) for q in queues]
                if any(lens):
                    v = pick_victim(lens)
                    if v != i and should_steal(rates[i] / fastest, lens[v]):
                        unit = queues[v].pop()     # steal from the tail
                        stolen = True
                        victim = names[v]
            if unit is None:
                return
            nid, n_jobs, macs, nbytes = unit
            dt = n_jobs * self.engines[i].cost.job_time(macs, nbytes)
            free[i] = False
            busy[i] += dt
            jobs_run[i] += n_jobs
            steals[i] += int(stolen)
            if tr is not None:
                jname = jobsets[nid].name
                if stolen:
                    tr.emit("steal", names[i], ts=now, victim=victim,
                            jobset=jname, priority=0, probe=False)
                else:
                    tr.emit("dequeue", names[i], ts=now, jobset=jname,
                            n_jobs=n_jobs)
                tr.span("panel", names[i], now, dt, jobset=jname,
                        n_jobs=n_jobs, stolen=stolen, priority=0)
            heapq.heappush(events, (now + dt, next(seq), i, nid))

        def kick_all() -> None:
            for i in range(len(self.engines)):
                try_dispatch(i)

        release([i for i in range(n) if remaining[i] == 0])
        kick_all()
        while events:
            now, _, i, nid = heapq.heappop(events)
            free[i] = True
            pending[nid] -= 1
            if pending[nid] == 0:
                node_finish[nid] = now
                if tr is not None:
                    tr.emit("graph_node_done", "graph", ts=now,
                            graph="sim-graph", node=nid,
                            node_name=jobsets[nid].name, ok=True)
                ready = []
                for s in succs[nid]:
                    remaining[s] -= 1
                    if remaining[s] == 0:
                        ready.append(s)
                release(ready)
                kick_all()
            else:
                try_dispatch(i)

        return SimGraphResult(
            makespan_s=now,
            per_engine_jobs=dict(zip(names, jobs_run)),
            per_engine_busy=dict(zip(names, busy)),
            per_engine_steals=dict(zip(names, steals)),
            node_finish_s=tuple(node_finish))
