"""The port's discrete-event simulator, planners and virtual-time runtime
against repro's: the same Python on the same calibrated constants, so every
result must be EXACTLY equal, field by field (no tolerance).

Covers simulate() over build_simnet() for all seven paper CNNs under
work stealing ("ws") and static mapping ("sf"), the SC cluster search,
the LPT planner and rebalancer, and SimRuntime.run / run_faults / run_qos
/ run_graph on a few seeds."""

import dataclasses
import random

import pytest

from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core import scheduler as jax_sched
from repro.core.job import JobSet as JaxJobSet
from repro.models.cnn import build_simnet as jax_build_simnet
from repro.soc import faults as jax_faults
from repro.soc.qos_policy import QosTag as JaxQosTag
from repro.soc.simrt import SimRuntime as JaxSimRuntime
from repro_torch.configs import PAPER_CNNS
from repro_torch.core import scheduler
from repro_torch.core.job import JobSet
from repro_torch.models.cnn import build_simnet
from repro_torch.soc import faults
from repro_torch.soc.qos_policy import QosTag
from repro_torch.soc.simrt import SimRuntime

CNNS = sorted(PAPER_CNNS)


def _plain(obj):
    """A result as plain data: dataclasses to dicts, recursively."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def test_the_port_has_the_same_paper_cnns():
    assert sorted(JAX_CNNS) == CNNS


@pytest.mark.parametrize("name", CNNS)
def test_build_simnet_equals_the_reference(name):
    assert _plain(build_simnet(PAPER_CNNS[name])) == \
        _plain(jax_build_simnet(JAX_CNNS[name]))


@pytest.mark.parametrize("policy", ["ws", "sf"])
@pytest.mark.parametrize("name", CNNS)
def test_simulate_equals_the_reference(name, policy):
    got = scheduler.simulate(build_simnet(PAPER_CNNS[name]), policy=policy,
                             frames=32)
    want = jax_sched.simulate(jax_build_simnet(JAX_CNNS[name]),
                              policy=policy, frames=32)
    assert _plain(got) == _plain(want)
    assert got.fps > 0


@pytest.mark.parametrize("name", ["CIFAR_Alex+", "MNIST"])
def test_search_sc_and_single_thread_latency_equal_the_reference(name):
    net, jnet = build_simnet(PAPER_CNNS[name]), jax_build_simnet(JAX_CNNS[name])
    assert _plain(scheduler.search_sc(net, frames=16)) == \
        _plain(jax_sched.search_sc(jnet, frames=16))
    assert scheduler.single_thread_latency(net) == \
        jax_sched.single_thread_latency(jnet)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lpt_plan_and_rebalance_equal_the_reference(seed):
    rng = random.Random(seed)
    dims = [(rng.randrange(32, 700), rng.randrange(8, 200),
             rng.randrange(8, 300)) for _ in range(9)]
    tile = rng.choice([16, 32])
    js = [JobSet.for_gemm(i, *d, tile) for i, d in enumerate(dims)]
    jjs = [JaxJobSet.for_gemm(i, *d, tile) for i, d in enumerate(dims)]
    parts = list(scheduler.cluster_partitions())
    jparts = list(jax_sched.cluster_partitions())
    k = rng.randrange(len(parts))
    assert scheduler.lpt_plan(js, parts[k]) == jax_sched.lpt_plan(jjs,
                                                                  jparts[k])
    shares = [rng.random() for _ in range(4)]
    shares = [s / sum(shares) for s in shares]
    times = [rng.uniform(0.1, 2.0) for _ in range(4)]
    assert scheduler.rebalance(shares, times) == \
        jax_sched.rebalance(shares, times)


def _gemm(seed):
    rng = random.Random(seed)
    dims = (rng.randrange(64, 400), rng.randrange(32, 160),
            rng.randrange(16, 120))
    return (JobSet.for_gemm(0, *dims, 32, name="g"),
            JaxJobSet.for_gemm(0, *dims, 32, name="g"))


@pytest.mark.parametrize("granularity", ["job", "row"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_runtime_run_equals_the_reference(seed, granularity):
    js, jjs = _gemm(seed)
    pool = ["F-PE", "S-PE", "NEON"]
    got = SimRuntime(pool).run(js, affinity="S-PE", granularity=granularity)
    want = JaxSimRuntime(pool).run(jjs, affinity="S-PE",
                                   granularity=granularity)
    assert _plain(got) == _plain(want)
    assert sum(got.per_engine_jobs.values()) == js.num_jobs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_runtime_run_faults_equals_the_reference(seed):
    js, jjs = _gemm(seed)
    pool = ["F-PE", "S-PE"]
    kinds = ("raise", "corrupt", "slowdown")
    plan = faults.FaultPlan.random(seed, pool, kinds=kinds)
    jplan = jax_faults.FaultPlan.random(seed, pool, kinds=kinds)
    got = SimRuntime(pool).run_faults(js, plan, faults.RetryPolicy(),
                                      affinity="F-PE")
    want = JaxSimRuntime(pool).run_faults(jjs, jplan,
                                          jax_faults.RetryPolicy(),
                                          affinity="F-PE")
    assert _plain(got) == _plain(want)
    assert got.completed_jobs == js.num_jobs


def test_sim_runtime_worker_death_equals_the_reference():
    js, jjs = _gemm(3)
    pool = ["F-PE", "S-PE"]
    got = SimRuntime(pool).run_faults(
        js, faults.FaultPlan((faults.FaultSpec("S-PE", "die", at_call=1),)),
        faults.RetryPolicy(), affinity="F-PE")
    want = JaxSimRuntime(pool).run_faults(
        jjs, jax_faults.FaultPlan(
            (jax_faults.FaultSpec("S-PE", "die", at_call=1),)),
        jax_faults.RetryPolicy(), affinity="F-PE")
    assert _plain(got) == _plain(want)
    assert got.worker_deaths == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_sim_runtime_run_qos_equals_the_reference(seed):
    rng = random.Random(seed)
    subs, jsubs = [], []
    for i in range(4):
        dims = (rng.randrange(32, 200), 64, rng.randrange(16, 96))
        prio = rng.choice([-10, 0, 10])
        deadline = rng.choice([float("inf"), rng.uniform(0.05, 2.0)])
        subs.append((JobSet.for_gemm(i, *dims, 32, name=f"s{i}"),
                     QosTag(prio, deadline)))
        jsubs.append((JaxJobSet.for_gemm(i, *dims, 32, name=f"s{i}"),
                      JaxQosTag(prio, deadline)))
    pool = ["F-PE", "S-PE", "NEON"]
    got = SimRuntime(pool).run_qos(subs, quarantined=["NEON"])
    want = JaxSimRuntime(pool).run_qos(jsubs, quarantined=["NEON"])
    assert _plain(got) == _plain(want)


def test_sim_runtime_run_graph_equals_the_reference():
    dims = [(128, 64, 48), (96, 64, 64), (160, 32, 32), (64, 64, 96)]
    edges = [(0, 1), (0, 2), (1, 3), (2, 3)]
    js = [JobSet.for_gemm(i, *d, 32, name=f"n{i}") for i, d in enumerate(dims)]
    jjs = [JaxJobSet.for_gemm(i, *d, 32, name=f"n{i}")
           for i, d in enumerate(dims)]
    got = SimRuntime(["F-PE", "S-PE"]).run_graph(js, edges)
    want = JaxSimRuntime(["F-PE", "S-PE"]).run_graph(jjs, edges)
    assert _plain(got) == _plain(want)
    with pytest.raises(ValueError, match="cycle"):
        SimRuntime(["F-PE"]).run_graph(js[:2], [(0, 1), (1, 0)])


def test_sim_runtime_conforms_to_the_des_work_stealing():
    """The port's virtual-time runtime and its simulate(policy='ws') make
    identical steal decisions for identical cost models."""
    from repro_torch.core.clusters import Accelerator, Cluster
    js = JobSet.for_gemm(0, 320, 128, 96, 32, name="conv0")
    net = scheduler.SimNet("one", (scheduler.SimLayer(
        "conv0", "conv", jobset=js, im2col_bytes=0),))
    clusters = [Cluster("A", (Accelerator("F-PE0", "F-PE"),)),
                Cluster("B", (Accelerator("S-PE0", "S-PE"),))]
    des = scheduler.simulate(net, clusters, policy="ws",
                             mapping={"conv0": 0}, frames=1, inflight=1,
                             warmup_frames=0)
    sim = SimRuntime(["F-PE", "S-PE"]).run(js, affinity="F-PE")
    des_busy = {"F-PE": des.per_cluster_busy["A"] * des.makespan_s,
                "S-PE": des.per_cluster_busy["B"] * des.makespan_s}
    for kind in ("F-PE", "S-PE"):
        assert sim.per_engine_busy[kind] == pytest.approx(des_busy[kind],
                                                          rel=1e-12)
    assert sim.makespan_s == pytest.approx(des.makespan_s, rel=1e-12)
    assert sim.total_steals > 0


def test_one_steal_policy_for_the_des_and_both_runtimes():
    import repro_torch.soc.policy as policy
    import repro_torch.soc.runtime as runtime
    import repro_torch.soc.simrt as simrt
    for mod in (scheduler, runtime, simrt):
        assert mod.should_steal is policy.should_steal
    assert runtime.lpt_pick is simrt.lpt_pick is policy.lpt_pick
