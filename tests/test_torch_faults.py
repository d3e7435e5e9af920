"""The port's fault injection and live recovery (``repro_torch.soc.faults``
and the recovery path of ``SynergyRuntime``) against ``repro``'s, on the
CPU.

Every scenario of ``tests/test_faults.py`` runs on both runtimes, under
the same name, and the property test of ``tests/test_faults_props.py``
runs over a fixed list of seeds (no Hypothesis, so nothing is written
under ``.hypothesis/``).  The pools are toy engines that all compute the
same fp32 product (``torch.matmul`` in the port, ``jnp.dot`` in
``repro``), so a merge does not depend on which engine ran a panel; the
mixed-precision cases run the real ``cuda-tiled`` / ``cuda-tiled-int8``
engines on CPU tensors.  Inputs come from numpy seeds.  Every runtime
takes ``device="cpu"`` in the port and runs under ``with``, heartbeat
timeouts are 1 s, and every wait has a timeout.

Order is forced by ``threading.Event`` gates, never by sleeps: a ``Hold``
engine starts its panels once its gate opens, and a gate opens on the
n-th injected fault (``Plan``), on the n-th panel to reach a hold, or on
the runtime's ``worker_death`` event (``Watch``).  So each gated scenario
injects the same faults on both runtimes, and ``plan.injected``, the
retries, worker deaths, orphan re-seeds, quarantines and execution counts
are held equal to ``repro``'s.  Outputs are held bitwise against the same
runtime's fault-free run, and within 1e-5 of ``repro``'s.  The serving
wave is not gated (its panels come one decode step at a time): it holds
the reference's invariants on both servers and equal tokens.
"""

import dataclasses
import json
import random
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.job as jax_job
import repro.obs.flightrec as jax_flightrec
import repro.obs.metrics as jax_metrics
import repro.obs.trace as jax_trace
import repro.soc as jax_soc
import repro.engines as jax_engines
from repro.quant import QuantizedEngine as JaxQuantizedEngine
import repro_torch.core.job as torch_job
import repro_torch.obs.flightrec as torch_flightrec
import repro_torch.obs.metrics as torch_metrics
import repro_torch.obs.trace as torch_trace
import repro_torch.soc as torch_soc
import repro_torch.engines as torch_engines
from repro_torch.quant import QuantizedEngine

# repro's engines import their kernel modules lazily, from several worker
# threads at once; importing them here keeps that import off the threads
import repro.kernels.tiled_mm.ops  # noqa: F401
import repro.kernels.vpu_mm.ops  # noqa: F401

TIMEOUT = 60
FP32_TOL = 1e-5
HEARTBEAT = dict(heartbeat_timeout_s=1.0, monitor_interval_s=0.05)


# --------------------------------------------------------------- the gates

class Gate:
    """A ``threading.Event`` that opens at the ``n``-th :meth:`hit`."""

    def __init__(self, n: int = 1):
        self.n = n
        self.hits = 0
        self.event = threading.Event()
        self._lock = threading.Lock()

    def hit(self) -> None:
        with self._lock:
            self.hits += 1
            if self.hits >= self.n:
                self.event.set()

    def wait(self) -> None:
        if not self.event.wait(TIMEOUT):
            raise TimeoutError(f"gate still shut after {self.hits} of "
                               f"{self.n} hits")


def _classes(Engine, CostModel, FaultPlan, Tracer, caps, matmul, cast):
    """The toy engine, the hold, the gated plan and the watching tracer,
    over one package's base classes."""

    class MathEngine(Engine):
        """Every instance computes the same fp32 ``act(a @ b + bias)``.
        ``pace_s`` is a fixed service time a panel (it steadies the
        measured rates the health EMA reads); ``seed`` adds a random delay
        of up to ``max_delay_s`` a panel, which varies steal timing and
        not the values."""

        def __init__(self, name, macs_per_s=5e8, *, int8=False,
                     pace_s=0.0, seed=None, max_delay_s=0.0):
            super().__init__(name, set(caps[:2]) | (
                {caps[2]} if int8 else set()),
                cost=CostModel(macs_per_s=macs_per_s))
            self.pace_s = pace_s
            self.rng = random.Random(seed) if seed is not None else None
            self.max_delay_s = max_delay_s

        def execute(self, a, b, *, bias=None, activation=None, tile=None,
                    out_dtype=None, precision=None):
            delay = self.pace_s + (self.rng.random() * self.max_delay_s
                                   if self.rng is not None else 0.0)
            if delay:
                time.sleep(delay)
            y = matmul(a, b)
            if bias is not None:
                y = y + bias
            if activation is not None:
                y = activation(y)
            return cast(y, out_dtype or a.dtype)

    class Hold(Engine):
        """``inner`` whose panels start once ``go`` opens; each panel that
        reaches the hold first hits ``arrive``."""

        def __init__(self, inner, go: Gate, arrive: Gate | None = None):
            super().__init__(inner.name, set(inner.capabilities),
                             cost=inner._cost)
            self.inner, self.go, self.arrive = inner, go, arrive
            self.telemetry = inner.telemetry

        def cost_on(self, device):
            return self.inner.cost_on(device)

        def execute(self, a, b, **kw):
            if self.arrive is not None:
                self.arrive.hit()
            self.go.wait()
            return self.inner.execute(a, b, **kw)

    class Plan(FaultPlan):
        """A FaultPlan that hits ``gate`` at every injection."""

        def __init__(self, specs, seed=None, gate: Gate | None = None):
            super().__init__(specs, seed=seed)
            self.gate = gate

        def record(self, engine, kind, call):
            super().record(engine, kind, call)
            if self.gate is not None:
                self.gate.hit()

    class Watch(Tracer):
        """A Tracer that hits ``gates[kind]`` at every event of that
        kind."""

        def __init__(self, **gates: Gate):
            super().__init__()
            self.gates = gates

        def emit(self, kind, track, **tags):
            super().emit(kind, track, **tags)
            gate = self.gates.get(kind)
            if gate is not None:
                gate.hit()

    return MathEngine, Hold, Plan, Watch


def _side(name, soc, job, trace, flightrec, metrics, engines, *, rt_kw,
          array, numpy, matmul, cast):
    math, hold, plan, watch = _classes(
        engines.Engine, engines.CostModel, soc.FaultPlan, trace.Tracer,
        (engines.CAP_GEMM, "epilogue", engines.CAP_INT8), matmul, cast)
    return SimpleNamespace(
        name=name, soc=soc, JobSet=job.JobSet, Tracer=trace.Tracer,
        EVENT_KINDS=trace.EVENT_KINDS, validate_events=trace.validate_events,
        FlightRecorder=flightrec.FlightRecorder, metrics=metrics,
        engines=engines, Math=math, Hold=hold, Plan=plan, Watch=watch,
        rt_kw=rt_kw, array=array, numpy=numpy)


PORT = _side("port", torch_soc, torch_job, torch_trace, torch_flightrec,
             torch_metrics, torch_engines, rt_kw={"device": "cpu"},
             array=torch.from_numpy, numpy=lambda t: t.numpy(),
             matmul=lambda a, b: torch.matmul(a.float(), b.float()),
             cast=lambda y, dt: y.to(dt))
REPRO = _side("repro", jax_soc, jax_job, jax_trace, jax_flightrec,
              jax_metrics, jax_engines, rt_kw={},
              array=jnp.asarray, numpy=np.asarray,
              matmul=lambda a, b: jnp.dot(a.astype(jnp.float32),
                                          b.astype(jnp.float32),
                                          preferred_element_type=jnp.float32),
              cast=lambda y, dt: y.astype(dt))
SIDES = (PORT, REPRO)


# ---------------------------------------------------------------- helpers

def _ab(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _pool(side, n=3, macs_per_s=5e8, **kw):
    return [side.Math(f"fe{i}", macs_per_s, **kw) for i in range(n)]


def _run_gemm(side, engines, *, retry=None, tracer=None, name="faults",
              m=256, k=64, n=48, seed=0, subs=1, affinity="fe0", **rt_kw):
    """``subs`` submissions of one (m, k, n) GEMM in 32-row panels; returns
    (outputs as numpy, futures, stats, the pool's names at the end)."""
    a, b = (side.array(x) for x in _ab(m, k, n, seed))
    with side.soc.SynergyRuntime(engines, name=name, retry=retry,
                                 tracer=tracer, **side.rt_kw,
                                 **rt_kw) as rt:
        futs = [rt.submit_gemm(
            a, b, jobset=side.JobSet.for_gemm(i, m, n, k, 32,
                                              name=f"g{i}"),
            tile=(32, 32, 32), affinity=affinity) for i in range(subs)]
        ys = [side.numpy(f.result(TIMEOUT)) for f in futs]
        stats = rt.stats()
        names = list(rt.engine_names)
    return ys, futs, stats, names


_CLEAN: dict = {}


def _clean(side, m=256, k=64, n=48, seed=0, subs=1):
    """The fault-free outputs of a 3-engine toy pool (cached)."""
    key = (side.name, m, k, n, seed, subs)
    if key not in _CLEAN:
        _CLEAN[key] = _run_gemm(side, _pool(side), m=m, k=k, n=n, seed=seed,
                                subs=subs)[0]
    return _CLEAN[key]


def _counters(plan, stats, futs):
    """What a gated scenario must give equally on both runtimes."""
    return {"injected": list(plan.injected),
            "retries": stats["retries"],
            "worker_deaths": stats["worker_deaths"],
            "orphan_reseeds": stats["orphan_reseeds"],
            "quarantines": stats["quarantines"],
            "future_retries": sum(f.retries for f in futs),
            "execution_counts": [list(f.execution_counts) for f in futs]}


def _dumps(directory):
    """The flight recorder's dumps in ``directory``, in order: reason, the
    engine, orphans and in-flight panels a death left, and the keys of
    the context, the stats view and the health snapshot."""
    out = []
    for path in sorted(Path(directory).glob("flightrec-*.json")):
        d = json.loads(path.read_text())
        ctx = d["context"]
        out.append((d["reason"], ctx.get("engine"), ctx.get("orphans"),
                    ctx.get("in_flight"), sorted(ctx), sorted(d["stats"]),
                    sorted(ctx.get("health", {}))))
    return out


def _outputs_hold(side, ys, clean, port_ys=None):
    """Bitwise the same runtime's fault-free run; repro's within 1e-5 of
    the port's."""
    assert len(ys) == len(clean)
    for y, c in zip(ys, clean):
        assert np.array_equal(y, c), side.name
    if port_ys is not None:
        for y, p in zip(ys, port_ys):
            np.testing.assert_allclose(p, y, rtol=FP32_TOL, atol=FP32_TOL)


def _both(scenario):
    """Run ``scenario(side)`` on the port and on repro: returns both
    results and holds their counters equal."""
    port, ref = scenario(PORT), scenario(REPRO)
    assert port["counters"] == ref["counters"]
    return port, ref


# -------------------------------------------------------------- the plan

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 43, 2**16])
def test_fault_plan_is_seed_reproducible(seed):
    engines = ["a", "b", "c"]
    for kw in ({}, {"n_faults": 5, "max_call": 3,
                    "kinds": ("raise", "die", "stall", "drop")}):
        p1 = torch_soc.FaultPlan.random(seed, engines, **kw)
        p2 = torch_soc.FaultPlan.random(seed, engines, **kw)
        ref = jax_soc.FaultPlan.random(seed, engines, **kw)
        assert p1.specs == p2.specs
        assert ([dataclasses.astuple(s) for s in p1.specs]
                == [dataclasses.astuple(s) for s in ref.specs])
        assert p1.seed == ref.seed == seed
    assert p1.specs != torch_soc.FaultPlan.random(seed + 1, engines,
                                                  **kw).specs
    # the default draw is retryable-only: the chaos-sweep contract
    assert all(s.kind in ("raise", "corrupt", "slowdown")
               for s in torch_soc.FaultPlan.random(seed, engines).specs)


def test_fault_spec_validation():
    for side in SIDES:
        spec = side.soc.FaultSpec
        with pytest.raises(ValueError, match="unknown fault kind"):
            spec("e", "meltdown")
        with pytest.raises(ValueError, match="count"):
            spec("e", "raise", count=0)
        with pytest.raises(ValueError, match="at_call"):
            spec("e", "raise", at_call=-1)
    assert torch_soc.FAULT_KINDS == jax_soc.FAULT_KINDS
    for at_call, count in ((0, 1), (2, 3), (5, 10_000)):
        s = torch_soc.FaultSpec("e", "raise", at_call=at_call, count=count)
        r = jax_soc.FaultSpec("e", "raise", at_call=at_call, count=count)
        assert ([s.hits(c) for c in range(12)]
                == [r.hits(c) for c in range(12)])
    s = torch_soc.FaultSpec("e", "raise", at_call=2, count=3)
    assert [s.hits(c) for c in range(6)] == [False, False, True, True,
                                             True, False]


def test_retry_policy_validation():
    for side in SIDES:
        with pytest.raises(ValueError, match="max_attempts"):
            side.soc.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError, match="monitor_interval_s"):
            side.soc.RetryPolicy(monitor_interval_s=0)
    assert (dataclasses.asdict(torch_soc.RetryPolicy())
            == dataclasses.asdict(jax_soc.RetryPolicy()))
    for hb in (0.01, 0.1, 0.5, 1.0, 2.5):
        for iv in (0.02, 0.05, 0.3, 1.0):
            kw = dict(heartbeat_timeout_s=hb, monitor_interval_s=iv)
            assert (torch_soc.RetryPolicy(**kw).timeout_steps
                    == jax_soc.RetryPolicy(**kw).timeout_steps)
    assert torch_soc.RetryPolicy(heartbeat_timeout_s=0.5,
                                 monitor_interval_s=0.05).timeout_steps == 10
    assert torch_soc.RetryPolicy(heartbeat_timeout_s=0.01,
                                 monitor_interval_s=1.0).timeout_steps == 1


def test_wrap_pool_only_wraps_targeted_engines():
    for side in SIDES:
        pool = _pool(side)
        plan = side.soc.FaultPlan((side.soc.FaultSpec("fe1", "raise"),),
                                  seed=0)
        wrapped = side.soc.wrap_pool(pool, plan)
        assert isinstance(wrapped[1], side.soc.FaultyEngine)
        assert wrapped[0] is pool[0] and wrapped[2] is pool[2]
        # delegation is attribute-faithful: no phantom int8 entry points
        assert not hasattr(wrapped[1], "execute_int8")
        assert wrapped[1].telemetry is pool[1].telemetry
        assert wrapped[1].cost.macs_per_s == pool[1].cost.macs_per_s
    # a quantized engine keeps its int8 entry point and its calibrator
    q = QuantizedEngine(torch_engines.get_engine("cuda-tiled"),
                        name="cuda-tiled-int8")
    plan = torch_soc.FaultPlan((torch_soc.FaultSpec(q.name, "raise"),))
    wq, = torch_soc.wrap_pool([q], plan)
    assert hasattr(wq, "execute_int8") and wq.calibrator is q.calibrator
    assert wq.cost_on("cpu") == q.cost_on("cpu")


def test_heartbeat_monitor_is_shared_definition():
    """One heartbeat-timeout definition, not two: the runtime's
    worker-death detector is the elastic-training monitor."""
    import repro_torch.runtime.fault_tolerance as ft
    import repro_torch.soc.runtime as rt_mod
    assert rt_mod.HeartbeatMonitor is ft.HeartbeatMonitor


# --------------------------------------------------- retry, bitwise merge

def _raise_twice(side):
    """fe1 raises on its first two panels.  fe0 and fe2 hold their first
    panel until both faults fired, so fe1 takes (steals) two panels
    whatever the host's thread timing."""
    fired = Gate(2)
    plan = side.Plan((side.soc.FaultSpec("fe1", "raise", at_call=0,
                                         count=2),), seed=3, gate=fired)
    tracer = side.Tracer()
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan, tracer=tracer)
    ys, futs, stats, _ = _run_gemm(
        side, [side.Hold(fe0, fired), fe1, side.Hold(fe2, fired)],
        retry=side.soc.RetryPolicy(max_attempts=3), tracer=tracer)
    return {"ys": ys, "futs": futs, "tracer": tracer,
            "counters": _counters(plan, stats, futs)}


def test_injected_raise_retries_bitwise_and_exactly_once():
    """Two injected panel exceptions cost two retries and nothing else:
    the merge is bitwise the fault-free run, every panel merged once."""
    port, ref = _both(_raise_twice)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side), port["ys"])
        c = run["counters"]
        assert c["injected"] == [("fe1", "raise", 0), ("fe1", "raise", 1)]
        assert c["retries"] == 2 and c["future_retries"] == 2
        assert c["execution_counts"] == [[1] * 8]
        fut, = run["futs"]
        assert sum(a["jobs"] for a in fut.accounting.values()) == 8 * 2
        kinds = {e.kind for e in run["tracer"].events()}
        assert {"fault_injected", "panel_retry"} <= kinds
        side.validate_events(run["tracer"].events())


def _always_raises_fe0(side):
    """fe0 raises on every panel.  It holds its first panel until fe1 and
    fe2 each hold one stolen panel, and they hold theirs until fe0 has
    faulted on the six panels left in its queue."""
    thieves, faulted = Gate(2), Gate(6)
    plan = side.Plan((side.soc.FaultSpec("fe0", "raise", at_call=0,
                                         count=10_000),), seed=0,
                     gate=faulted)
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan)
    ys, futs, stats, _ = _run_gemm(
        side, [side.Hold(fe0, thieves), side.Hold(fe1, faulted, thieves),
               side.Hold(fe2, faulted, thieves)],
        retry=side.soc.RetryPolicy(max_attempts=3))
    return {"ys": ys, "counters": _counters(plan, stats, futs)}


def test_retry_avoids_failed_engine():
    """fe0 always raises: the submission succeeds only because each retry
    re-seeds onto another engine, and succeeds there at its first try."""
    port, ref = _both(_always_raises_fe0)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side), port["ys"])
        c = run["counters"]
        assert c["injected"] == [("fe0", "raise", i) for i in range(6)]
        assert c["retries"] == len(c["injected"]) == 6
        assert c["execution_counts"] == [[1] * 8]


def test_retry_exhaustion_raises_and_dumps_flight(tmp_path):
    """A panel that fails everywhere surfaces PanelRetryExhausted with its
    audit trail, and the flight recorder dumps the post-mortem."""
    seen = {}
    for side in SIDES:
        plan = side.soc.FaultPlan(
            tuple(side.soc.FaultSpec(f"fe{i}", "raise", at_call=0,
                                     count=10_000) for i in range(2)),
            seed=0)
        tracer = side.Tracer()
        out = tmp_path / side.name
        flight = side.FlightRecorder(tracer, dir=str(out))
        a, b = (side.array(x) for x in _ab(64, 32, 32))
        with side.soc.SynergyRuntime(
                side.soc.wrap_pool(_pool(side, 2), plan, tracer=tracer),
                name="exhaust", retry=side.soc.RetryPolicy(max_attempts=2),
                tracer=tracer, flight_recorder=flight, **side.rt_kw) as rt:
            fut = rt.submit_gemm(
                a, b, jobset=side.JobSet.for_gemm(0, 64, 32, 32, 32,
                                                  name="doom"),
                tile=(32, 32, 32))
            with pytest.raises(side.soc.PanelRetryExhausted) as ei:
                fut.result(TIMEOUT)
            stats = rt.stats()
        e = ei.value
        assert e.jobset_name == "doom" and e.attempts == 2
        assert isinstance(e.last, side.soc.InjectedFault)
        assert sorted(e.engines) == ["fe0", "fe1"]
        dumps = list(out.glob("flightrec-*retry_exhausted*.json"))
        assert dumps, "retry exhaustion must flight-record a post-mortem"
        # both panels fail twice, on both engines: 4 faults, 2 retries
        seen[side.name] = (len(plan.injected),
                           sorted(k for _, k, _ in plan.injected),
                           stats["retries"], len(dumps))
    assert seen["port"] == seen["repro"] == (4, ["raise"] * 4, 2, 2)


def test_backoff_delays_reseed():
    seen = {}
    for side in SIDES:
        fired = Gate(1)
        plan = side.Plan((side.soc.FaultSpec("fe0", "raise", at_call=0,
                                             count=1),), seed=0, gate=fired)
        fe0, fe1 = side.soc.wrap_pool(_pool(side, 2), plan)
        t0 = time.perf_counter()
        ys, futs, stats, _ = _run_gemm(
            side, [fe0, side.Hold(fe1, fired)],
            retry=side.soc.RetryPolicy(max_attempts=3, backoff_s=0.15))
        assert time.perf_counter() - t0 >= 0.15
        _outputs_hold(side, ys, _clean(side))
        seen[side.name] = _counters(plan, stats, futs)
    assert seen["port"] == seen["repro"]
    assert seen["port"]["retries"] == 1


# ------------------------------------------------------------ worker death

def _death(side):
    """fe1 dies on its first panel.  It holds that panel until fe0 and fe2
    each hold one stolen panel, and they hold theirs until the monitor
    has declared fe1 dead: the corpse leaves one in-flight and five
    queued panels to re-seed."""
    thieves, dead = Gate(2), Gate(1)
    plan = side.Plan((side.soc.FaultSpec("fe1", "die", at_call=0),),
                     seed=0)
    tracer = side.Watch(worker_death=dead)
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan, tracer=tracer)
    with tempfile.TemporaryDirectory() as flight_dir:
        ys, futs, stats, names = _run_gemm(
            side, [side.Hold(fe0, dead, thieves), side.Hold(fe1, thieves),
                   side.Hold(fe2, dead, thieves)],
            retry=side.soc.RetryPolicy(**HEARTBEAT), tracer=tracer,
            affinity="fe1",
            flight_recorder=side.FlightRecorder(tracer, dir=flight_dir))
        dumps = _dumps(flight_dir)
    return {"ys": ys, "names": names, "tracer": tracer,
            "counters": {**_counters(plan, stats, futs), "dumps": dumps}}


def test_worker_death_reseeds_orphans_bitwise():
    """A worker killed mid-panel: the heartbeat monitor detects the dead
    thread, retires the engine, and the orphans (queued AND the panel it
    died holding) re-seed onto the survivors."""
    port, ref = _both(_death)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side), port["ys"])
        assert "fe1" not in run["names"]      # retired, not respawned
        c = run["counters"]
        assert c["injected"] == [("fe1", "die", 0)]
        assert c["worker_deaths"] == 1 and c["orphan_reseeds"] == 6
        assert c["execution_counts"] == [[1] * 8]
        # the post-mortem: the corpse held one panel and left five queued
        (dump,) = c["dumps"]
        assert dump[:4] == ("worker_death", "fe1", 6, 1)
        kinds = {e.kind for e in run["tracer"].events()}
        assert {"worker_death", "orphan_reseed", "fault_injected"} <= kinds
    for kind in ("fault_injected", "worker_death", "orphan_reseed"):
        assert (_tag_keys(port["tracer"].events(), kind)
                == _tag_keys(ref["tracer"].events(), kind)), kind


def _drop(side):
    """fe2's first panel computes and its completion is lost; fe0 and fe1
    hold their first panel until then.  The stall timeout (1 s) is far
    above any real panel's time here."""
    fired = Gate(1)
    plan = side.Plan((side.soc.FaultSpec("fe2", "drop", at_call=0),),
                     seed=0, gate=fired)
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan)
    ys, futs, stats, _ = _run_gemm(
        side, [side.Hold(fe0, fired), side.Hold(fe1, fired), fe2],
        retry=side.soc.RetryPolicy(stall_timeout_s=1.0, **HEARTBEAT))
    return {"ys": ys, "counters": _counters(plan, stats, futs)}


def test_dropped_completion_recovered_by_stall_sweep():
    """Only the stall sweep's duplicate re-execution recovers a dropped
    completion, and the idempotent per-index merge keeps it safe."""
    port, ref = _both(_drop)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side), port["ys"])
        c = run["counters"]
        assert c["injected"] == [("fe2", "drop", 0)]
        assert c["retries"] == 1
        # exactly-once MERGE even though a panel executed twice
        assert c["execution_counts"] == [[1] * 8]


# --------------------------------------------------------- integrity guard

def _corrupt(side, check):
    fired = Gate(1)
    plan = side.Plan((side.soc.FaultSpec("fe1", "corrupt", at_call=0),),
                     seed=0, gate=fired)
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan)
    ys, futs, stats, _ = _run_gemm(
        side, [side.Hold(fe0, fired), fe1, side.Hold(fe2, fired)],
        retry=side.soc.RetryPolicy(max_attempts=3, check_outputs=check))
    return {"ys": ys, "counters": _counters(plan, stats, futs)}


def test_corrupt_output_guard_opt_in():
    """check_outputs=True turns NaN corruption into a retryable fault;
    without the guard the corruption merges silently (documented)."""
    port, ref = _both(lambda side: _corrupt(side, True))
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side), port["ys"])
        assert np.isfinite(run["ys"][0]).all()
        assert run["counters"]["retries"] == 1
    # the guard is opt-in: check_outputs=False lets one panel of NaN in
    port, ref = _both(lambda side: _corrupt(side, False))
    for run in (port, ref):
        y, = run["ys"]
        assert run["counters"]["retries"] == 0
        assert int(np.isnan(y).any(axis=1).sum()) == 32


def test_screen_reads_float_partials_only():
    """The screen flags NaN and Inf in float partials and passes the int8
    path's int32 accumulators."""
    screen = torch_soc.SynergyRuntime._screen_output
    assert not screen(torch.ones(4, 3))
    assert screen(torch.tensor([[1.0, float("nan")]]))
    assert screen(torch.tensor([[float("-inf"), 0.0]]))
    assert not screen(torch.full((2, 2), 7, dtype=torch.int32))
    assert not screen(None)


# ----------------------------------------------------- health integration

def _quarantine(side):
    """fe1 never completes a panel, so it has no healthy baseline and
    min_samples straight faults quarantine it.  fe0 and fe2 run at a fixed
    pace, and the threshold is far below their rates' noise (a healthy
    engine would need seven panels in a row 400x slower than its peak):
    the reference's 0.2 lets a loaded host quarantine them too."""
    plan = side.soc.FaultPlan((side.soc.FaultSpec("fe1", "raise",
                                                  at_call=0,
                                                  count=10_000),), seed=0)
    health = side.soc.HealthPolicy(alpha=0.5, quarantine_below=0.01,
                                   min_samples=3, probe_interval_s=1e9)
    pool = side.soc.wrap_pool(_pool(side, pace_s=0.001), plan)
    with tempfile.TemporaryDirectory() as flight_dir:
        ys, futs, stats, _ = _run_gemm(
            side, pool, retry=side.soc.RetryPolicy(max_attempts=4),
            health=health, m=512, subs=6, affinity=None,
            flight_recorder=side.FlightRecorder(None, dir=flight_dir))
        dumps = _dumps(flight_dir)
    return {"ys": ys, "stats": stats,
            "counters": {**_counters(plan, stats, futs), "dumps": dumps}}


def test_repeated_faults_quarantine_engine():
    """Faults drive the health EMA toward zero and trip the same
    quarantine a thermal collapse would: fe1 never completes a healthy
    panel, so min_samples straight faults quarantine it, and it takes no
    panel after that."""
    port, ref = _both(_quarantine)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side, m=512, subs=6),
                      port["ys"])
        fe1 = run["stats"]["engines"]["fe1"]
        assert fe1["faults"] == 3 and fe1["quarantined"]
        assert run["counters"]["quarantines"] == 1
        assert run["counters"]["retries"] == 3
        (dump,) = run["counters"]["dumps"]
        assert dump[:2] == ("quarantine", "fe1") and "faults" in dump[6]
    assert (port["stats"]["engines"]["fe1"]["faults"]
            == ref["stats"]["engines"]["fe1"]["faults"])


# ------------------------------------------------------- drain-error fix

def test_drained_jobsets_get_distinct_exception_instances():
    """Each drained jobset completes with its own copy of the error, naming
    the jobset.  The engine holds its first panel until the drain is done,
    so the other three are still queued."""
    for side in SIDES:
        started, drained = Gate(1), Gate(1)
        slow = side.Hold(side.Math("slow"), drained, started)
        a, b = (side.array(x) for x in _ab(64, 32, 32))
        caught = {}
        with side.soc.SynergyRuntime([slow], name="drain",
                                     **side.rt_kw) as rt:
            futs = [rt.submit_gemm(
                a, b, jobset=side.JobSet.for_gemm(i, 64, 32, 32, 32,
                                                  name=f"js{i}"),
                tile=(32, 32, 32)) for i in range(2)]
            started.wait()
            with rt._cond:
                n = rt._drain_jobs_locked(lambda j: True,
                                          RuntimeError("upstream failed"))
            drained.hit()
            for i, f in enumerate(futs):
                with pytest.raises(RuntimeError) as ei:
                    f.result(TIMEOUT)
                caught[i] = ei.value
        assert n == 3
        assert caught[0] is not caught[1]
        for i in (0, 1):
            assert f"js{i}" in str(caught[i])
            assert "upstream failed" in str(caught[i])


# ------------------------------------------------------ graph node retry

def _graph(side, run0, retries):
    tracer = side.Tracer()
    with side.soc.SynergyRuntime(_pool(side, 2), name="gretry",
                                 tracer=tracer, **side.rt_kw) as rt:
        gf = rt.submit_graph(
            [side.soc.GraphNode(name="first", run=run0),
             side.soc.GraphNode(name="after", run=lambda rt, v: v + 1)],
            [(0, 1)], name="retrygraph", node_retries=retries)
        try:
            vals = gf.result(TIMEOUT)
        except side.soc.InjectedFault as e:
            vals = e
    return vals, gf, {e.kind for e in tracer.events()}


def test_graph_node_retries_before_cancel():
    """A failing graph node re-launches up to node_retries times BEFORE the
    failure cancels descendants."""
    seen = {}
    for side in SIDES:
        attempts = {"n": 0}

        def flaky(rt, side=side, attempts=attempts):
            attempts["n"] += 1
            if attempts["n"] == 1:
                raise side.soc.InjectedFault("first launch fails")
            return 41

        vals, gf, kinds = _graph(side, flaky, 1)
        assert vals == [41, 42]
        assert "graph_node_retry" in kinds
        seen[side.name] = (attempts["n"], gf.retries, gf.node_states())
    assert seen["port"] == seen["repro"]
    assert seen["port"][:2] == (2, 1)


def test_graph_node_retry_exhaustion_still_cancels():
    seen = {}
    for side in SIDES:
        def doomed(rt, side=side):
            raise side.soc.InjectedFault("always fails")

        vals, gf, _ = _graph(side, doomed, 2)
        assert isinstance(vals, side.soc.InjectedFault)
        seen[side.name] = (gf.retries, gf.node_states())
    assert seen["port"] == seen["repro"]
    assert seen["port"][0] == 2


# ------------------------------------------------------------ observability

def test_fault_event_kinds_are_registered():
    assert {"fault_injected", "panel_retry", "worker_death",
            "orphan_reseed", "graph_node_retry"} <= PORT.EVENT_KINDS
    assert PORT.EVENT_KINDS == REPRO.EVENT_KINDS


FAULT_COUNTERS = ("repro_runtime_retries_total",
                  "repro_runtime_worker_deaths_total",
                  "repro_runtime_orphan_reseeds_total")


def test_metrics_export_fault_counters():
    seen = {}
    for side in SIDES:
        fired = Gate(1)
        plan = side.Plan((side.soc.FaultSpec("fe1", "raise", at_call=0),),
                         seed=0, gate=fired)
        fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan)
        a, b = (side.array(x) for x in _ab(128, 32, 32))
        with side.soc.SynergyRuntime(
                [side.Hold(fe0, fired), fe1, side.Hold(fe2, fired)],
                name="metrics", retry=side.soc.RetryPolicy(max_attempts=3),
                **side.rt_kw) as rt:
            rt.submit_gemm(
                a, b, jobset=side.JobSet.for_gemm(0, 128, 32, 32, 32,
                                                  name="m0"),
                tile=(32, 32, 32)).result(TIMEOUT)
            reg = side.metrics.MetricsRegistry()
            side.metrics.collect_runtime(rt, reg)
        text = reg.render()
        assert "repro_runtime_retries_total" in text
        seen[side.name] = [reg.counter(c).value for c in FAULT_COUNTERS]
        seen[side.name + " lines"] = [
            line for line in text.splitlines()
            if line.startswith(FAULT_COUNTERS)]
    assert seen["port"] == seen["repro"] == [1, 0, 0]
    assert seen["port lines"] == seen["repro lines"]


def test_stats_reset_zeroes_fault_counters():
    seen = {}
    for side in SIDES:
        fired = Gate(1)
        plan = side.Plan((side.soc.FaultSpec("fe0", "raise", at_call=0),),
                         seed=0, gate=fired)
        fe0, fe1 = side.soc.wrap_pool(_pool(side, 2), plan)
        a, b = (side.array(x) for x in _ab(64, 32, 32))
        with side.soc.SynergyRuntime(
                [fe0, side.Hold(fe1, fired)], name="rst",
                retry=side.soc.RetryPolicy(max_attempts=3),
                **side.rt_kw) as rt:
            rt.submit_gemm(
                a, b, jobset=side.JobSet.for_gemm(0, 64, 32, 32, 32,
                                                  name="r0"),
                tile=(32, 32, 32), affinity="fe0").result(TIMEOUT)
            before = rt.stats()["retries"]
            rt.reset_stats()
            st = rt.stats()
            live = dict(rt._live_panels)
        seen[side.name] = (before, st["retries"], st["worker_deaths"],
                           st["orphan_reseeds"], st["quarantines"], live)
    assert seen["port"] == seen["repro"] == (1, 0, 0, 0, 0, {})


# --------------------------------------------------------- sim conformance

def _tag_keys(events, kind):
    return {frozenset(e.tags) for e in events if e.kind == kind}


def _sim_result(r):
    return (r.retries, r.worker_deaths, r.orphan_reseeds, r.exhausted,
            tuple(r.injected), r.completed_jobs, r.makespan_s,
            r.per_engine_jobs, r.per_engine_busy, r.per_engine_steals)


def test_sim_fault_trace_conforms_to_live_schema():
    """SimRuntime.run_faults emits the same event kinds and tag keys as
    the live runtime for an equivalent plan, with exactly-once virtual
    accounting: in the port, in repro, and across the two."""
    live = {"port": _raise_twice(PORT)["tracer"].events(),
            "repro": _raise_twice(REPRO)["tracer"].events()}
    sim, res = {}, {}
    for side in SIDES:
        js = side.JobSet.for_gemm(0, 320, 128, 96, 32, name="conv0")
        plan = side.soc.FaultPlan((side.soc.FaultSpec(
            "S-PE", "raise", at_call=0, count=2),), seed=5)
        tracer = side.Tracer()
        r = side.soc.SimRuntime(["F-PE", "S-PE"], tracer=tracer).run_faults(
            js, plan, side.soc.RetryPolicy(max_attempts=3), affinity="F-PE")
        assert r.completed_jobs == js.num_jobs     # exactly-once
        assert r.retries == 2 and r.exhausted == 0
        side.validate_events(tracer.events())
        sim[side.name], res[side.name] = tracer.events(), _sim_result(r)
    assert res["port"] == res["repro"]
    for kind in ("fault_injected", "panel_retry"):
        keys = [_tag_keys(ev, kind) for ev in (live["port"], sim["port"],
                                                live["repro"], sim["repro"])]
        assert keys[0], kind
        assert all(k == keys[0] for k in keys), kind
    assert ([(e.kind, e.track) for e in sim["port"]]
            == [(e.kind, e.track) for e in sim["repro"]])


def test_sim_worker_death_reseeds_in_virtual_time():
    res = {}
    for side in SIDES:
        js = side.JobSet.for_gemm(0, 320, 128, 96, 32, name="conv0")
        runs = []
        for _ in range(2):       # same plan, same virtual outcome
            plan = side.soc.FaultPlan((side.soc.FaultSpec(
                "S-PE", "die", at_call=1),), seed=0)
            runs.append(_sim_result(side.soc.SimRuntime(
                ["F-PE", "S-PE"]).run_faults(
                js, plan, side.soc.RetryPolicy(), affinity="F-PE")))
        assert runs[0] == runs[1]
        r = runs[0]
        assert r[5] == js.num_jobs
        assert r[1] == 1 and r[2] >= 1
        res[side.name] = r
    assert res["port"] == res["repro"]


def test_sim_rejects_wall_clock_kinds():
    for side in SIDES:
        js = side.JobSet.for_gemm(0, 64, 64, 32, 32)
        for kind in ("stall", "drop"):
            plan = side.soc.FaultPlan((side.soc.FaultSpec("F-PE", kind),),
                                      seed=0)
            with pytest.raises(ValueError, match="wall-clock"):
                side.soc.SimRuntime(["F-PE"]).run_faults(
                    js, plan, side.soc.RetryPolicy())


# -------------------------------------------------- serving survives faults

def _serve(pools, retry=None):
    """Three requests through a repro server and a port server on the
    same reduced granite, each over a runtime of its pool; returns each
    side's tokens and ServeStats."""
    from test_torch_serving import requests, servers
    jpool, tpool = pools
    with jax_soc.SynergyRuntime(jpool, name="srv", retry=retry[0]
                                if retry else None) as jrt, \
            torch_soc.SynergyRuntime(tpool, name="srv", device="cpu",
                                     retry=retry[1] if retry else None
                                     ) as trt:
        js, ts = servers(slots=2, jax_kw={"runtime": jrt},
                         torch_kw={"runtime": trt})
        jr, tr = requests(3, toks=lambda i: np.random.default_rng(i)
                          .integers(0, 128, 4), max_new=4)
        for srv, reqs in ((js, jr), (ts, tr)):
            for r in reqs:
                srv.submit(r)
        jst, tst = js.run(), ts.run()
    return ([list(r.out) for r in jr], jst), ([list(r.out) for r in tr], tst)


def test_serving_wave_survives_engine_crash():
    """A serving wave with a worker killed mid-run completes every request
    with token streams equal to the fault-free run (and to repro's), and
    the retries surface in ServeStats.runtime_retries."""
    (jtok, jst), (ttok, tst) = _serve((_pool(REPRO), _pool(PORT)))
    assert jst.runtime_retries == tst.runtime_retries == 0
    assert ttok == jtok
    plans = [side.soc.FaultPlan(
        (side.soc.FaultSpec("fe1", "die", at_call=0),
         side.soc.FaultSpec("fe0", "raise", at_call=0, count=2)), seed=11)
        for side in (REPRO, PORT)]
    pools = [side.soc.wrap_pool(_pool(side), plan)
             for side, plan in zip((REPRO, PORT), plans)]
    retry = [side.soc.RetryPolicy(max_attempts=4, **HEARTBEAT)
             for side in (REPRO, PORT)]
    (jf, jfst), (tf, tfst) = _serve(pools, retry)
    assert tf == ttok and jf == jtok          # token streams unchanged
    for st, plan in ((jfst, plans[0]), (tfst, plans[1])):
        assert st.runtime_retries >= 1
        assert len(plan.injected) >= 2
        assert st.tokens_out == tst.tokens_out


# ------------------------------------------------------- chaos acceptance

def _chaos(side):
    """fe2 dies on its second panel, fe1 raises on its first two, over four
    submissions of twelve panels seeded on fe0.  fe0 holds its first panel
    until the monitor declared fe2 dead; fe1 holds its first until fe2
    died, so both raises re-seed onto fe2's queue, where no survivor may
    take them (fe1 failed them, fe0 is held): fe2 leaves one in-flight and
    two queued orphans."""
    died, dead = Gate(1), Gate(1)
    plan = side.Plan((side.soc.FaultSpec("fe2", "die", at_call=1),
                      side.soc.FaultSpec("fe1", "raise", at_call=0,
                                         count=2)), seed=23, gate=died)
    tracer = side.Watch(worker_death=dead)
    fe0, fe1, fe2 = side.soc.wrap_pool(_pool(side), plan, tracer=tracer)
    ys, futs, stats, _ = _run_gemm(
        side, [side.Hold(fe0, dead), side.Hold(fe1, died), fe2],
        retry=side.soc.RetryPolicy(max_attempts=4, **HEARTBEAT),
        tracer=tracer, m=384, seed=7, subs=4)
    return {"ys": ys, "futs": futs, "tracer": tracer,
            "counters": _counters(plan, stats, futs)}


def test_chaos_acceptance_crash_plus_exceptions_bitwise():
    """A worker crash mid-submission plus two injected panel exceptions:
    every submission completes bitwise the fault-free run, the trace shows
    the retries and orphan re-seeds, and no future hangs."""
    port, ref = _both(_chaos)
    for side, run in ((PORT, port), (REPRO, ref)):
        _outputs_hold(side, run["ys"], _clean(side, m=384, seed=7, subs=4),
                      port["ys"])
        c = run["counters"]
        assert c["injected"] == [("fe2", "die", 1), ("fe1", "raise", 0),
                                 ("fe1", "raise", 1)]
        assert c["worker_deaths"] == 1 and c["retries"] == 2
        assert c["orphan_reseeds"] == 3
        assert c["execution_counts"] == [[1] * 12] * 4
        assert all(f.done() for f in run["futs"])
        kinds = {e.kind for e in run["tracer"].events()}
        assert {"fault_injected", "panel_retry", "worker_death",
                "orphan_reseed"} <= kinds
        side.validate_events(run["tracer"].events())
    for kind in ("fault_injected", "panel_retry", "worker_death",
                 "orphan_reseed"):
        assert (_tag_keys(port["tracer"].events(), kind)
                == _tag_keys(ref["tracer"].events(), kind)), kind


def test_fault_free_pool_has_no_monitor_thread():
    """retry=None keeps the hot path untouched: no monitor thread, no
    live-panel registry entries."""
    for side in SIDES:
        a, b = (side.array(x) for x in _ab(64, 32, 32))
        with side.soc.SynergyRuntime(_pool(side, 2), name="clean",
                                     **side.rt_kw) as rt:
            rt.submit_gemm(
                a, b, jobset=side.JobSet.for_gemm(0, 64, 32, 32, 32,
                                                  name="c0"),
                tile=(32, 32, 32)).result(TIMEOUT)
            assert rt._monitor is None
            assert not rt._live_panels
            st = rt.stats()
        assert st["retries"] == 0 and st["worker_deaths"] == 0


# --------------------------------------------- mixed precision under death

def _mixed_pools(fp32):
    """(repro's pool, the port's): the fp32 engines named by ``fp32`` plus
    an int8 engine over the tiled one, in each package."""
    jq = JaxQuantizedEngine(jax_engines.get_engine("pallas"),
                            name="pallas-int8")
    tq = QuantizedEngine(torch_engines.get_engine("cuda-tiled"),
                         name="cuda-tiled-int8")
    jnames = [{"cuda-tiled": "pallas"}.get(n, n) for n in fp32]
    return ([jax_engines.get_engine(n) for n in jnames] + [jq],
            [torch_engines.get_engine(n) for n in fp32] + [tq])


def _mixed(side, pool, dead_name):
    """An fp32 GEMM over a pool with an int8 worker; the tiled engine dies
    on its first panel.  Mixed-pool panels are pinned to their LPT seed,
    so its queue is orphaned whole."""
    plan = side.soc.FaultPlan((side.soc.FaultSpec(dead_name, "die",
                                                  at_call=0),), seed=0)
    a, b = (side.array(x) for x in _ab(128, 32, 16, seed=4))
    with side.soc.SynergyRuntime(side.soc.wrap_pool(pool, plan),
                                 name="mixed",
                                 retry=side.soc.RetryPolicy(**HEARTBEAT),
                                 **side.rt_kw) as rt:
        fut = rt.submit_gemm(a, b, jobset=side.JobSet.for_gemm(
            0, 128, 16, 32, 32, name="mixed"), tile=(32, 32, 32))
        try:
            y = side.numpy(fut.result(TIMEOUT))
        except RuntimeError as e:
            y = e
        stats = rt.stats()
    return y, fut, stats, plan


def test_orphaned_fp32_panel_never_reseeds_onto_the_int8_worker():
    (jpool, tpool) = _mixed_pools(["cuda-tiled", "neon-vpu"])
    seen = {}
    for side, pool, dead, int8 in ((PORT, tpool, "cuda-tiled",
                                    "cuda-tiled-int8"),
                                   (REPRO, jpool, "pallas", "pallas-int8")):
        y, fut, stats, plan = _mixed(side, pool, dead)
        a, b = _ab(128, 32, 16, seed=4)
        np.testing.assert_allclose(y, a @ b, rtol=FP32_TOL, atol=FP32_TOL)
        assert int8 not in fut.accounting and stats["engines"][int8][
            "jobs"] == 0
        assert set(fut.accounting) == {"neon-vpu"}
        assert fut.execution_counts == [1] * 4
        seen[side.name] = (plan.injected[0][1:], stats["worker_deaths"],
                           stats["orphan_reseeds"] >= 1, stats["retries"])
        if side is PORT:
            # bitwise the fault-free split (the plain versions' rows do
            # not depend on which engine ran them)
            ref = np.asarray(torch.matmul(*(torch.from_numpy(x)
                                            for x in (a, b))))
            np.testing.assert_allclose(y, ref, rtol=FP32_TOL, atol=FP32_TOL)
            with torch_soc.SynergyRuntime(tpool[:2], name="mixed-clean",
                                          device="cpu") as rt:
                clean = rt.submit_gemm(
                    torch.from_numpy(a), torch.from_numpy(b),
                    jobset=torch_job.JobSet.for_gemm(0, 128, 16, 32, 32),
                    tile=(32, 32, 32)).result(TIMEOUT).numpy()
            assert np.array_equal(y, clean)
    assert seen["port"] == seen["repro"] == (("die", 0), 1, True, 0)


def test_orphans_with_no_eligible_worker_fail_the_submission():
    (jpool, tpool) = _mixed_pools(["cuda-tiled"])
    seen = {}
    for side, pool, dead in ((PORT, tpool, "cuda-tiled"),
                             (REPRO, jpool, "pallas")):
        err, fut, stats, plan = _mixed(side, pool, dead)
        assert isinstance(err, RuntimeError)
        assert "no precision-eligible engine" in str(err)
        seen[side.name] = (stats["worker_deaths"], plan.injected[0][1:],
                           fut.done())
    assert seen["port"] == seen["repro"] == (1, ("die", 0), True)


# ------------------------------------- the property test, at fixed seeds

#: (plan, steal, workload) seeds; the reference draws them with Hypothesis
PROP_SEEDS = [(0, 0, 0), (1, 2, 3), (17, 5, 9), (42, 42, 42),
              (123, 77, 4), (999, 31, 8), (4096, 1, 65535), (65536, 9, 2)]


@pytest.mark.parametrize("plan_seed,steal_seed,wl_seed", PROP_SEEDS)
def test_random_fault_plans_exactly_once_bitwise_no_hangs(plan_seed,
                                                          steal_seed,
                                                          wl_seed):
    """For a random retryable plan (raise / corrupt / slowdown) over a
    mixed fp32/int8-capable pool with seeded random steal timing: every
    panel completes exactly once, every GEMM's merge is bitwise the
    fault-free split (each 32-row panel's own product: a panel's rows do
    not depend on which engine ran it), and no future hangs."""
    rng = random.Random(wl_seed)
    names = ["pf0", "pf1", "pf2"]
    # pf2 advertises int8, so the steal filter (int8 thieves only take
    # int8-ok panels) is exercised under faults
    pool = [PORT.Math(names[0], seed=steal_seed, max_delay_s=0.002),
            PORT.Math(names[1], 3e8, seed=steal_seed + 1, max_delay_s=0.002),
            PORT.Math(names[2], 4e8, int8=True, seed=steal_seed + 2,
                      max_delay_s=0.002)]
    plan = torch_soc.FaultPlan.random(plan_seed, names)
    assert plan.specs == tuple(
        torch_soc.FaultSpec(**dataclasses.asdict(s))
        for s in jax_soc.FaultPlan.random(plan_seed, names).specs)
    retry = torch_soc.RetryPolicy(max_attempts=6, backoff_s=0.0,
                                  avoid_failed_engine=True,
                                  check_outputs=True)
    d = 64
    g = np.random.default_rng(wl_seed)
    w = torch.from_numpy(g.standard_normal((d, 48)).astype(np.float32))
    mats = [torch.from_numpy(g.standard_normal(
        (32 * rng.randint(1, 4), d)).astype(np.float32))
        for _ in range(rng.randint(2, 4))]
    with torch_soc.SynergyRuntime(torch_soc.wrap_pool(pool, plan),
                                  name="fprop", retry=retry,
                                  device="cpu") as rt:
        futs = [rt.submit_gemm(
            a, w, jobset=torch_job.JobSet.for_gemm(i, a.shape[0], 48, d, 32,
                                                   name=f"fp{i}"),
            tile=(32, 32, 32)) for i, a in enumerate(mats)]
        for f, a in zip(futs, mats):
            got = f.result(TIMEOUT)            # no hung futures
            assert f.done()
            assert f.execution_counts == [1] * len(f.execution_counts)
            assert sum(x["jobs"] for x in f.accounting.values()) \
                == f.jobset.num_jobs
            want = torch.cat([torch.matmul(p, w) for p in a.split(32)])
            assert torch.equal(got, want)
        stats = rt.stats()
    # every injected fault that raised or corrupted was absorbed as a retry
    assert stats["retries"] == sum(
        1 for (_, kind, _) in plan.injected if kind in ("raise", "corrupt"))
    # per-engine counters count BURNED work (failed attempts included)
    assert stats["total_jobs"] >= sum(f.jobset.num_jobs for f in futs)
