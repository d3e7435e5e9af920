"""The port's work-stealing SynergyRuntime on the CPU (``device="cpu"``):
split GEMMs and the paper-CNN forward against repro's runtime on the same
numpy inputs, exactly-once execution under stealing, live pool changes,
the thread-local scope, worker death and dropped completions, the locked
launch counts, and the device contract.

The pools mix simulated PEs with ``cuda-tiled`` and ``neon-vpu``, which
run their kernels' plain versions on CPU tensors.  Tolerances: 1e-5 for
one split GEMM (fp32, panels summed in another order than one matmul),
1e-4 for CNN logits (five GEMMs).  Every wait has a timeout and every
runtime is shut down by ``with``; heartbeat timeouts are >= 1 s.  Also the
between-step straggler rebalancer, its shares and job splits exactly
repro's."""

import random
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro's engines import their kernel modules lazily, from several worker
# threads at once; importing them here keeps that import off the threads
import repro.kernels.tiled_mm.ops  # noqa: F401
import repro.kernels.vpu_mm.ops  # noqa: F401
from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core.job import JobSet as JaxJobSet
from repro.models import cnn as jax_cnn
from repro.runtime import StragglerRebalancer as JaxRebalancer
from repro.soc import SynergyRuntime as JaxSynergyRuntime
from repro_torch.configs import PAPER_CNNS
from repro_torch.core.job import JobSet
from repro_torch.core.synergy_mm import SynergyTrace, synergy_matmul
from repro_torch.engines import CAP_GEMM, CostModel, Engine, get_engine
from repro_torch.kernels.common.gemm import count_launch
from repro_torch.kernels.tiled_mm import tiled_matmul
from repro_torch.kernels.vpu_mm import vpu_matmul
from repro_torch.models import cnn
from repro_torch.runtime import StragglerRebalancer
from repro_torch.soc import (FaultPlan, FaultSpec, RetryPolicy,
                             SynergyRuntime, current_runtime, runtime_scope,
                             wrap_pool)

POOL = ["F-PE", "S-PE", "cuda-tiled", "neon-vpu"]
TIMEOUT = 30


def _ab(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((n,)).astype(np.float32))


class _DelayEngine(Engine):
    """Deterministic-output engine with seeded random per-panel delays:
    randomized steal timing without randomized results."""

    def __init__(self, name, macs_per_s=1e9, seed=0, max_delay_s=0.004):
        super().__init__(name, {CAP_GEMM, "epilogue"},
                         cost=CostModel(macs_per_s=macs_per_s))
        self._rng = random.Random(seed)
        self._max_delay_s = max_delay_s
        self.executed = 0

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        time.sleep(self._rng.random() * self._max_delay_s)
        self.executed += 1
        y = torch.matmul(a.float(), b.float())
        if bias is not None:
            y = y + bias
        if activation is not None:
            y = activation(y)
        return y.to(out_dtype or a.dtype)


def _split(engines, a, b, tile, **kw):
    m, k = a.shape
    js = JobSet.for_gemm(0, m, b.shape[1], k, tile)
    with SynergyRuntime(engines, device="cpu") as rt:
        fut = rt.submit_gemm(a, b, jobset=js, tile=(tile,) * 3, **kw)
        return fut.result(TIMEOUT), fut, rt.stats()


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("shape", [(160, 40, 24), (70, 33, 45)])
def test_submit_gemm_matches_the_reference_runtime(shape):
    a, b, bias = _ab(*shape)
    m, k = a.shape
    n = b.shape[1]
    y, fut, _ = _split(POOL, torch.from_numpy(a), torch.from_numpy(b), 16,
                       bias=torch.from_numpy(bias), activation=torch.relu)
    with JaxSynergyRuntime(["F-PE", "S-PE", "pallas", "neon-vpu"]) as jrt:
        jfut = jrt.submit_gemm(jnp.asarray(a), jnp.asarray(b),
                               jobset=JaxJobSet.for_gemm(0, m, n, k, 16),
                               bias=jnp.asarray(bias),
                               activation=jax.nn.relu, tile=(16, 16, 16))
        want = jfut.result(TIMEOUT)
    assert y.shape == (m, n) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert fut.execution_counts == [1] * len(jfut.execution_counts)
    assert sum(x["jobs"] for x in fut.accounting.values()) == \
        sum(x["jobs"] for x in jfut.accounting.values())


def test_cnn_forward_through_the_runtime_matches_the_reference():
    cfg, jcfg = PAPER_CNNS["CIFAR_Alex+"], JAX_CNNS["CIFAR_Alex+"]
    jparams = jax_cnn.init_cnn(jcfg, jax.random.key(0))
    x = np.random.default_rng(1).standard_normal(
        (1, jcfg.input_hw, jcfg.input_hw, jcfg.cin)).astype(np.float32)
    params = cnn.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, device="cpu")
    with JaxSynergyRuntime(["F-PE", "S-PE", "NEON"]) as jrt:
        want = jax_cnn.cnn_forward(jcfg, jparams, jnp.asarray(x),
                                   runtime=jrt)
    tr = SynergyTrace()
    with SynergyRuntime(POOL, name="cnn", device="cpu") as rt, \
            tr.activate():
        got = cnn.cnn_forward(cfg, params, torch.from_numpy(x), runtime=rt,
                              device="cpu")
        stats = rt.stats()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    n_gemm = sum(1 for s in cfg.layers if s[0] in ("conv", "fc"))
    assert stats["submissions"] == n_gemm == len(tr.jobsets)
    # every panel booked once; the split GEMM counts once in the trace
    assert stats["total_jobs"] == tr.num_jobs
    assert sum(t.gemms for t in tr.engine_stats.values()) == n_gemm
    assert set(tr.engine_stats) <= set(POOL)


# ----------------------------------------------- exactly once, stealing

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_panel_executes_exactly_once_under_stealing(seed):
    """However steals interleave, each panel executes once and the merge
    is bitwise the same row panels run serially on one engine."""
    engines = [_DelayEngine(f"d{i}", macs_per_s=(i + 1) * 1e9,
                            seed=seed * 10 + i) for i in range(3)]
    a, b, _ = _ab(17 * 16, 40, 24, seed=seed)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    y, fut, stats = _split(engines, a, b, 16)
    assert fut.execution_counts == [1] * 17
    assert sum(x["jobs"] for x in fut.accounting.values()) == 17 * 2
    assert sum(e.executed for e in engines) == 17 == stats["total_jobs"] // 2
    solo = _DelayEngine("solo", max_delay_s=0.0)
    parts = [solo.execute(a[r:r + 16], b) for r in range(0, a.shape[0], 16)]
    assert torch.equal(y, torch.cat(parts))


def test_slow_engine_steals_from_a_deep_queue():
    """All panels seeded onto the fast engine (affinity): the idle slow
    engine steals from the deep queue, and the merge stays exact."""
    fast = _DelayEngine("fast", macs_per_s=16e9, seed=5, max_delay_s=0.005)
    slow = _DelayEngine("slow", macs_per_s=1e9, seed=6, max_delay_s=0.0)
    a, b, _ = _ab(24 * 16, 32, 16, seed=4)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    y, fut, stats = _split([fast, slow], a, b, 16, affinity="fast")
    assert stats["engines"]["slow"]["steals"] > 0
    assert slow.executed > 0 and fast.executed + slow.executed == 24
    assert fut.execution_counts == [1] * 24
    np.testing.assert_allclose(y.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ live pool changes

def test_add_engine_mid_run_rebalances():
    slow = _DelayEngine("slow-only", seed=1, max_delay_s=0.01)
    helper = _DelayEngine("helper", seed=2, max_delay_s=0.0)
    a, b, _ = _ab(24 * 16, 32, 16, seed=7)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    js = JobSet.for_gemm(0, a.shape[0], 16, 32, 16)
    with SynergyRuntime([slow], device="cpu") as rt:
        fut = rt.submit_gemm(a, b, jobset=js, tile=(16, 16, 16))
        rt.add_engine(helper)
        y = fut.result(TIMEOUT)
        assert rt.stats()["rebalances"] >= 1
    assert helper.executed > 0, "added engine never picked up queued work"
    assert slow.executed + helper.executed == 24
    np.testing.assert_allclose(y.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_remove_engine_mid_run_work_still_completes():
    doomed = _DelayEngine("doomed", seed=3, max_delay_s=0.01)
    survivor = _DelayEngine("survivor", seed=4, max_delay_s=0.0)
    a, b, _ = _ab(24 * 16, 32, 16, seed=8)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    js = JobSet.for_gemm(0, a.shape[0], 16, 32, 16)
    with SynergyRuntime([doomed, survivor], device="cpu") as rt:
        fut = rt.submit_gemm(a, b, jobset=js, tile=(16, 16, 16),
                             affinity="doomed")
        rt.remove_engine("doomed")
        y = fut.result(TIMEOUT)
        assert "doomed" not in rt.engine_names
        stats = rt.stats()
    assert fut.execution_counts == [1] * 24
    assert survivor.executed > 0
    assert stats["total_jobs"] == js.num_jobs
    np.testing.assert_allclose(y.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ the scope

def test_runtime_scope_is_thread_local_and_nests():
    seen = {}

    def other_thread():
        seen["runtime"] = current_runtime()

    rt1 = SynergyRuntime(["F-PE"], name="outer", device="cpu")
    rt2 = SynergyRuntime(["S-PE"], name="inner", device="cpu")
    try:
        with runtime_scope(rt1):
            assert current_runtime() is rt1
            with runtime_scope(rt2):
                assert current_runtime() is rt2
                t = threading.Thread(target=other_thread)
                t.start()
                t.join(TIMEOUT)
                assert not t.is_alive()
            assert current_runtime() is rt1
        assert current_runtime() is None
    finally:
        rt1.shutdown()
        rt2.shutdown()
    assert seen["runtime"] is None


def test_scope_splits_synergy_matmul_and_keeps_grad_off_the_pool():
    a, b, _ = _ab(96, 24, 20, seed=9)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    with SynergyRuntime(POOL, device="cpu") as rt, rt.scope():
        y = synergy_matmul(a, b, tile=32)
        assert rt.stats()["total_jobs"] == 3
        # autograd records this GEMM: the pool's kernels have no backward,
        # so it takes single-engine dispatch onto a grad-safe engine
        w = b.clone().requires_grad_(True)
        yg = synergy_matmul(a, w, tile=32)
        assert rt.stats()["total_jobs"] == 3
        yg.sum().backward()
    np.testing.assert_allclose(y.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)
    assert w.grad is not None


# --------------------------------------------------------------- faults

class _AfterFault(Engine):
    """Runs ``inner``'s panels once ``plan`` has injected a fault: a
    survivor that cannot finish the whole GEMM before the doomed worker
    takes its first panel, however the host schedules the two threads."""

    def __init__(self, inner, plan):
        super().__init__(inner.name, set(inner.capabilities),
                         cost=inner._cost)
        self.inner, self.plan = inner, plan
        self.telemetry = inner.telemetry

    def cost_on(self, device):
        return self.inner.cost_on(device)

    def execute(self, a, b, **kw):
        deadline = time.monotonic() + TIMEOUT
        while not self.plan.injected and time.monotonic() < deadline:
            time.sleep(0.001)
        return self.inner.execute(a, b, **kw)


def test_worker_death_reseeds_orphans_exactly_once():
    """The neon-vpu worker dies holding its first panel: the heartbeat
    monitor (timeout 1 s) retires it, and its in-flight and queued panels
    re-seed onto the survivor; the merge equals the fault-free run.  The
    survivor starts its first panel only after the death, so it cannot
    steal all twelve panels first when the host starves the doomed
    worker's thread."""
    a, b, bias = (torch.from_numpy(x) for x in _ab(12 * 16, 40, 24, seed=11))
    kw = dict(bias=bias, activation=torch.relu)
    ref, _, _ = _split(["cuda-tiled", "neon-vpu"], a, b, 16, **kw)
    plan = FaultPlan((FaultSpec("neon-vpu", "die", at_call=0),), seed=0)
    pool = wrap_pool([_AfterFault(get_engine("cuda-tiled"), plan),
                      get_engine("neon-vpu")], plan)
    retry = RetryPolicy(heartbeat_timeout_s=1.0, monitor_interval_s=0.05)
    js = JobSet.for_gemm(0, a.shape[0], 24, 40, 16)
    with SynergyRuntime(pool, device="cpu", retry=retry) as rt:
        fut = rt.submit_gemm(a, b, jobset=js, tile=(16, 16, 16),
                             affinity="neon-vpu", **kw)
        y = fut.result(TIMEOUT)
        stats = rt.stats()
        assert "neon-vpu" not in rt.engine_names
    assert stats["worker_deaths"] == 1 and stats["orphan_reseeds"] >= 1
    assert fut.execution_counts == [1] * 12
    assert plan.injected == [("neon-vpu", "die", 0)]
    assert torch.equal(y, ref)


def test_dropped_completion_recovered_by_the_stall_sweep():
    a, b, _ = (torch.from_numpy(x) for x in _ab(8 * 16, 32, 16, seed=12))
    ref, _, _ = _split(["cuda-tiled", "neon-vpu"], a, b, 16)
    plan = FaultPlan((FaultSpec("cuda-tiled", "drop", at_call=0),), seed=0)
    pool = wrap_pool([get_engine("cuda-tiled"), get_engine("neon-vpu")],
                     plan)
    retry = RetryPolicy(heartbeat_timeout_s=1.0, stall_timeout_s=0.3,
                        monitor_interval_s=0.05)
    js = JobSet.for_gemm(0, a.shape[0], 16, 32, 16)
    with SynergyRuntime(pool, device="cpu", retry=retry) as rt:
        fut = rt.submit_gemm(a, b, jobset=js, tile=(16, 16, 16))
        y = fut.result(TIMEOUT)
        stats = rt.stats()
    assert stats["retries"] >= 1
    assert plan.injected == [("cuda-tiled", "drop", 0)]
    assert fut.execution_counts == [1] * 8
    assert torch.equal(y, ref)


# ------------------------------------------------------ launch counting

def test_launch_counts_are_not_lost_across_threads():
    """count_launch is the only writer of the wrappers' counts; with many
    threads and a tiny switch interval an unlocked += would lose some."""
    old = sys.getswitchinterval()
    before = (tiled_matmul.launches, vpu_matmul.launches)
    n_threads, per_thread = 16, 2000

    def hammer():
        for _ in range(per_thread):
            count_launch(tiled_matmul)
            count_launch(vpu_matmul)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert tiled_matmul.launches - before[0] == n_threads * per_thread
    assert vpu_matmul.launches - before[1] == n_threads * per_thread
    tiled_matmul.launches, vpu_matmul.launches = before


# --------------------------------------------------------- device contract

def test_runtime_defaults_to_the_card_and_checks_operand_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SynergyRuntime(POOL)
    a = torch.ones(32, 8)
    with SynergyRuntime(POOL, device="cpu") as rt:
        assert rt.device == torch.device("cpu")
        with pytest.raises(ValueError, match="runs on cpu"):
            rt.submit_gemm(a, torch.ones(8, 4, device="meta"),
                           jobset=JobSet.for_gemm(0, 32, 4, 8, 16))


def test_workers_rank_engines_on_the_runtime_device():
    """Worker rates come from cost_on(device), not from whether this
    process sees a card: a CPU runtime ranks neon-vpu at its CPU rate."""
    with SynergyRuntime(POOL, device="cpu") as rt:
        w = rt._workers["neon-vpu"]
        assert w.rate == get_engine("neon-vpu").cost_on("cpu").macs_per_s
        assert w.stream is None


# ---------------------------------------------------------------------------
# the between-step straggler rebalancer (runtime/straggler.py), against
# repro's: shares and job splits exactly equal
# ---------------------------------------------------------------------------

def test_straggler_rebalancer_shifts_work():
    """Cluster 1 runs at half speed; its share should fall toward 1/3."""
    rb, jrb = StragglerRebalancer(2, ema=0.5), JaxRebalancer(2, ema=0.5)
    shares = rb.shares
    for _ in range(40):
        times = [shares[0] / 1.0, shares[1] / 0.5]
        shares = rb.observe(times)
        assert shares == jrb.observe(times)
    assert abs(shares[0] - 2 / 3) < 0.05
    assert rb.history == jrb.history
    counts = rb.split_jobs(90)
    assert counts == jrb.split_jobs(90)
    assert sum(counts) == 90
    assert counts[0] > counts[1]


def test_split_jobs_exact():
    rb, jrb = StragglerRebalancer(3), JaxRebalancer(3)
    for n in (100, 7, 0, 1, 2):
        assert rb.split_jobs(n) == jrb.split_jobs(n)
        assert sum(rb.split_jobs(n)) == n
    times = [0.3, 0.1, 0.2]
    assert rb.observe(times) == jrb.observe(times)
    for n in (100, 7, 5):
        assert rb.split_jobs(n) == jrb.split_jobs(n)
        assert sum(rb.split_jobs(n)) == n
