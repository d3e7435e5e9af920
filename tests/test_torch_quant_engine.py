"""The port's quantized engine family (repro_torch.quant.engine and
.calibrate) and the runtime's int32-partial split, against repro on the
same numpy inputs, plus mirrors of tests/test_quant_engine.py:36-419 and
tests/test_act_quant.py:77-228.

The whole int8 CIFAR_Alex+ forward (2 frames, random biases) is held
BITWISE against repro's on both entry paths: the dispatcher
(``cuda-tiled-int8`` against ``pallas-int8``, fused epilogue) and a
``device="cpu"`` runtime (int32 panels, one merge).  The CPU pools run the
kernels' plain versions.  Every wait has a timeout and every runtime runs
under ``with``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro's engines import their kernel modules lazily, from several worker
# threads at once; importing them here keeps that import off the threads
import repro.kernels.qmm.ops  # noqa: F401
import repro.kernels.tiled_mm.ops  # noqa: F401
from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core.job import JobSet as JaxJobSet
from repro.engines import get_engine as jax_get_engine
from repro.engines import unregister_engine as jax_unregister_engine
from repro.models import cnn as jax_cnn
from repro.quant import CalibrationError as JaxCalibrationError
from repro.quant import QuantizedEngine as JaxQuantizedEngine
from repro.quant import register_quantized as jax_register_quantized
from repro.quant import rel_err as jax_rel_err
from repro.soc import SynergyRuntime as JaxSynergyRuntime
from repro_torch.configs import PAPER_CNNS
from repro_torch.core.job import JobSet
from repro_torch.core.synergy_mm import SynergyTrace, synergy_matmul
from repro_torch.engines import (CAP_EPILOGUE, CAP_GEMM, CAP_GRAD, CAP_INT8,
                                 CAP_ORACLE, ENGINE_NAME_MAP, CostModel,
                                 Dispatcher, Engine, find_engine, get_engine,
                                 registered, unregister_engine)
from repro_torch.engines.sim import SIM_ENGINE_SPECS, SimPEEngine
from repro_torch.kernels.qmm import qmm_matmul
from repro_torch.models import cnn
from repro_torch.quant import (ActCalibrator, CalibrationError,
                               QuantizedEngine, calibrate, quant_gemm,
                               quantize_weights, register_quantized, rel_err)
from repro_torch.soc import SynergyRuntime

TIMEOUT = 60


def _ab(m, k, n, seed=0, wscale=0.05):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((k, n)) * wscale)
                             .astype(np.float32)))


def _rel(y, ref):
    return float((y.float() - ref.float()).abs().max()
                 / (ref.float().abs().max() + 1e-9))


# ------------------------------------------------ the whole int8 forward

@pytest.fixture(scope="module")
def alex_plus():
    """CIFAR_Alex+ parameters from repro's init (biases made random), and
    2 frames, as (jax params, port params, numpy frames)."""
    cfg = JAX_CNNS["CIFAR_Alex+"]
    rng = np.random.default_rng(1)
    params = {k: np.asarray(v) for k, v in
              jax_cnn.init_cnn(cfg, jax.random.key(0)).items()}
    for k in params:
        if k.endswith("_b"):
            params[k] = (rng.standard_normal(params[k].shape) * 0.1).astype(
                np.float32)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in params.items()},
            cnn.params_from_jax(params, device="cpu"), x)


def test_int8_dispatcher_forward_is_bitwise_repro(alex_plus):
    jp, tp, x = alex_plus
    jeng = jax_register_quantized("pallas", name="pallas-int8")
    try:
        want = jax_cnn.cnn_forward(JAX_CNNS["CIFAR_Alex+"], jp,
                                   jnp.asarray(x), engine="pallas-int8",
                                   job_class="decode")
    finally:
        jax_unregister_engine(jeng.name)
    eng = register_quantized("cuda-tiled", device="cpu")
    assert eng.name == ENGINE_NAME_MAP["pallas-int8"]
    tr = SynergyTrace()
    try:
        with tr.activate():
            got = cnn.cnn_forward(PAPER_CNNS["CIFAR_Alex+"], tp,
                                  torch.from_numpy(x), job_class="decode",
                                  device="cpu")
    finally:
        unregister_engine(eng.name)
    assert set(tr.engine_stats) == {"cuda-tiled-int8"}   # decode prefers it
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fp32 = cnn.cnn_forward(PAPER_CNNS["CIFAR_Alex+"], tp, torch.from_numpy(x),
                           device="cpu")
    assert rel_err(got, fp32) <= 0.05


def test_int8_runtime_forward_is_bitwise_repro(alex_plus):
    jp, tp, x = alex_plus
    jeng = JaxQuantizedEngine(jax_get_engine("pallas"), name="pallas-int8")
    with JaxSynergyRuntime(["pallas", jeng]) as rt:
        want = jax_cnn.cnn_forward(JAX_CNNS["CIFAR_Alex+"], jp,
                                   jnp.asarray(x), runtime=rt,
                                   job_class="decode")
    eng = QuantizedEngine(get_engine("cuda-tiled"), name="cuda-tiled-int8")
    tr = SynergyTrace()
    with SynergyRuntime(["cuda-tiled", eng], device="cpu") as rt, \
            tr.activate():
        got = cnn.cnn_forward(PAPER_CNNS["CIFAR_Alex+"], tp,
                              torch.from_numpy(x), runtime=rt,
                              job_class="decode", device="cpu")
        stats = rt.stats()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every GEMM was split, and every tile job ran once
    assert stats["submissions"] == 5
    assert stats["total_jobs"] == sum(js.num_jobs for js in tr.jobsets)
    assert "cuda-tiled-int8" in {n for _, sh in tr.runtime_shares for n in sh}


# ------------------------------------------ engine: conformance + mirrors

def test_quantized_engine_wraps_and_strips_grad():
    base = get_engine("torch")
    q = QuantizedEngine(base)
    assert q.name == "torch-int8" == ENGINE_NAME_MAP["xla-int8"]
    assert CAP_INT8 in q.capabilities
    assert not q.capabilities & {CAP_GRAD, CAP_ORACLE, CAP_EPILOGUE}
    for dev in ("cpu", "cuda"):
        assert q.cost_on(dev).macs_per_s == pytest.approx(
            base.cost_on(dev).macs_per_s * q.speedup)
    a, w = _ab(33, 70, 45, seed=2)        # border shapes
    bias = torch.from_numpy(np.random.default_rng(5).standard_normal(45)
                            .astype(np.float32))
    y = q.execute(a, w, bias=bias, activation=torch.relu, tile=(32, 32, 32))
    ref = get_engine("reference").execute(a, w, bias=bias,
                                          activation=torch.relu)
    assert _rel(y, ref) < 0.05


def test_engine_output_is_bitwise_repro_s():
    """The same first batch through torch-int8 and repro's xla-int8: both
    observe it, publish the same scale and run the int8 path."""
    a, w = _ab(33, 70, 45, seed=3)
    bias = torch.ones(45)
    q = QuantizedEngine(get_engine("torch"))
    jq = JaxQuantizedEngine(jax_get_engine("xla"))
    y = q.execute(a, w, bias=bias, activation=torch.relu)
    jy = jq.execute(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()),
                    bias=jnp.ones(45), activation=jax.nn.relu)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert q.act_scale_for(70, 45) == jq.act_scale_for(70, 45)


@pytest.mark.parametrize("base_name", ["cuda-tiled", "neon-vpu"])
def test_quantized_engine_over_tiled_bases(base_name):
    """The dequant lives OUTSIDE the base engine, so n wider than a block
    works on the weight-only path and on the int8 path."""
    q = QuantizedEngine(get_engine(base_name), name=f"{base_name}-q")
    a, w = _ab(8, 64, 80, seed=12)
    bias = torch.linspace(-1, 1, 80)
    ref = get_engine("reference").execute(a, w, bias=bias,
                                          activation=torch.relu)
    y0 = q.execute_weight_only(a, w, bias=bias, activation=torch.relu)
    y1 = q.execute(a, w, bias=bias, activation=torch.relu)
    assert _rel(y0, ref) < 0.05 and _rel(y1, ref) < 0.05


def test_quantized_engine_caches_weights_by_identity():
    q = QuantizedEngine(get_engine("torch"))
    _, w = _ab(8, 32, 16, seed=3)
    qw1 = q.quantized(w)
    assert q.quantized(w) is qw1           # identity hit, no requantization
    _, w2 = _ab(8, 32, 16, seed=4)
    assert q.quantized(w2) is not qw1
    assert q.quantized(w.clone()) is not qw1   # equal values, other tensor


def test_engine_flips_to_int8_path_after_observation():
    q = QuantizedEngine(get_engine("torch"), name="flip-int8")
    a, w = _ab(8, 48, 16, seed=2)
    assert q.act_scale_for(48, 16) is None
    before = qmm_matmul.launches
    y = q.execute(a, w)
    assert q.act_scale_for(48, 16) is not None
    y2 = q.execute(a, w)
    for out in (y, y2):
        assert _rel(out, a @ w) < 0.05
    assert qmm_matmul.launches == before     # CPU tensors: no kernel launch


def test_engine_without_calibrator_stays_weight_only():
    q = QuantizedEngine(get_engine("torch"), name="wo-int8", calibrator=None)
    a, w = _ab(8, 48, 16, seed=3)
    q.execute(a, w)
    assert q.act_scale_for(48, 16) is None
    ref = quant_gemm(a, quantize_weights(w))
    assert torch.equal(q.execute(a, w), ref)


def test_execute_weight_only_never_observes():
    q = QuantizedEngine(get_engine("torch"), name="pin-wo-int8")
    a, w = _ab(8, 48, 16, seed=4)
    y = q.execute_weight_only(a, w)
    assert q.act_scale_for(48, 16) is None
    assert _rel(y, a @ w) < 0.05


# ------------------------------------------------------- calibration

def test_calibrate_attaches_report_and_measures_the_int8_path():
    q = QuantizedEngine(get_engine("torch"), name="gate-int8")
    report = calibrate(q, tol=0.05, device="cpu")
    assert q.calibration is report
    assert report.passed and report.max_rel_err < 0.05
    assert report.int8_path and "int8x8" in str(report)
    assert report.measured_macs_per_s and report.measured_macs_per_s > 0
    assert len(report.rows) >= 4 and "PASS" in str(report)


def test_calibration_gate_warms_slow_publishing_calibrators():
    slow = calibrate(QuantizedEngine(get_engine("torch"), name="mu2-int8",
                                     calibrator=ActCalibrator(min_updates=2)),
                     tol=0.05, device="cpu")
    assert slow.int8_path


@pytest.mark.parametrize("tol,passes", [(1e-9, False), (0.05, True)])
def test_register_quantized_gates_like_repro(tol, passes):
    """Same refuse/pass decision on both sides, and on shared inputs the
    same rel_err (to summation order of the fp32 oracle)."""
    for register, error, unregister, find, base in (
            (register_quantized, CalibrationError, unregister_engine,
             find_engine, "torch"),
            (jax_register_quantized, JaxCalibrationError,
             jax_unregister_engine, None, "xla")):
        kw = {"device": "cpu"} if register is register_quantized else {}
        if not passes:
            with pytest.raises(error):
                register(base, name="never-lands", tol=tol, **kw)
            if find is not None:
                assert find("never-lands") is None
            continue
        eng = register(base, name="tmp-int8", tol=tol, **kw)
        try:
            assert eng.calibration is not None and eng.calibration.passed
        finally:
            unregister("tmp-int8")
    if passes:
        assert find_engine("tmp-int8") is None
    a, w = _ab(64, 128, 32, seed=5)
    got = QuantizedEngine(get_engine("torch")).execute(a, w)
    jgot = JaxQuantizedEngine(jax_get_engine("xla")).execute(
        jnp.asarray(a.numpy()), jnp.asarray(w.numpy()))
    assert rel_err(got, a @ w) == pytest.approx(
        jax_rel_err(jgot, jnp.asarray(a.numpy()) @ jnp.asarray(w.numpy())),
        rel=1e-4)


def test_register_quantized_installs_the_measured_rate():
    base = get_engine("torch")
    eng = register_quantized("torch", name="rate-int8", device="cpu")
    try:
        assert eng.cost_on("cpu").macs_per_s == pytest.approx(
            eng.calibration.measured_macs_per_s)
        assert eng.cost_on("cpu").macs_per_s != pytest.approx(
            base.cost_on("cpu").macs_per_s * eng.speedup)
    finally:
        unregister_engine("rate-int8")


def test_register_quantized_keeps_sim_base_constants():
    fpe = get_engine("F-PE")
    eng = register_quantized(fpe, name="sim-int8", device="cpu")
    try:
        assert eng.cost.macs_per_s == pytest.approx(
            fpe.cost.macs_per_s * eng.speedup)
    finally:
        unregister_engine("sim-int8")


# ------------------------------------------------------ dispatch routing

def test_auto_dispatch_never_silently_quantizes():
    js = JobSet.for_gemm(0, 64, 64, 64, 32)
    q = QuantizedEngine(get_engine("torch"), name="fast-int8")
    with registered(q):
        for dev in ("cpu", "cuda"):
            assert Dispatcher().select(js, device=dev).name != "fast-int8"
            assert Dispatcher().select(js, job_class="decode",
                                       device=dev).name == "fast-int8"
        assert Dispatcher().select(js, engine="fast-int8") is q
        for cls in ("prefill", "train"):
            assert CAP_GRAD in Dispatcher().select(
                js, job_class=cls).capabilities


def test_decode_class_falls_back_without_int8_engines():
    js = JobSet.for_gemm(0, 64, 64, 64, 32)
    eng = Dispatcher().select(js, job_class="decode")
    assert CAP_INT8 not in eng.capabilities   # graceful: best fp32 engine


def test_differentiated_gemm_never_lands_on_int8():
    """The autograd guard (repro's jax.grad cases): a decode-class GEMM
    under autograd takes a grad-safe engine, and an int8 pin raises."""
    a, w = _ab(8, 16, 12, seed=7, wscale=1.0)
    a.requires_grad_()
    q = QuantizedEngine(get_engine("torch"), name="pin-int8")
    with registered(q):
        tr = SynergyTrace()
        with tr.activate():
            synergy_matmul(a, w, tile=8, job_class="decode").sum().backward()
        assert "pin-int8" not in tr.engine_stats
        assert a.grad is not None and bool((a.grad != 0).any())
        with pytest.raises(ValueError, match="grad"):
            synergy_matmul(a, w, tile=8, engine="pin-int8")


def test_unknown_job_class_raises():
    js = JobSet.for_gemm(0, 64, 64, 64, 32)
    with pytest.raises(KeyError, match="unknown job class"):
        Dispatcher().select(js, job_class="training")
    fp32, int8 = _mixed_pool(seed=4)
    a, w = _ab(2 * 16, 32, 16, seed=17)
    with SynergyRuntime([fp32, int8], name="typo", device="cpu") as rt:
        with pytest.raises(KeyError, match="unknown job class"):
            rt.submit_gemm(a, w, jobset=JobSet.for_gemm(0, 32, 16, 32, 16),
                           tile=(16, 16, 16), job_class="Decode")


# --------------------------------------- mixed-precision runtime pools

def _mixed_pool(seed=0):
    fp32 = SimPEEngine(f"mp-fp32-{seed}", SIM_ENGINE_SPECS["F-PE"])
    return fp32, QuantizedEngine(fp32, name=f"mp-int8-{seed}")


def _split(rt, a, w, **kw):
    js = JobSet.for_gemm(0, a.shape[0], w.shape[1], a.shape[1], 16)
    return rt.submit_gemm(a, w, jobset=js, tile=(16, 16, 16), **kw)


class _SlowInt8(QuantizedEngine):
    """Sleeps before each int32 panel: its deep queue stays deep long
    enough for the slow fp32 thief to steal (a slow thief only steals
    from a queue deeper than STEAL_QUEUE_DEPTH, so both engines run
    panels whatever the threads' timing)."""

    def execute_int8(self, a_q, qw, *, tile=(256, 256, 256)):
        import time
        time.sleep(0.002)
        return super().execute_int8(a_q, qw, tile=tile)


def test_decode_split_uses_int32_partials_and_steals():
    """A calibrated decode GEMM splits into raw int32 panels that ANY
    engine may run, so the split stays stealable on a mixed pool, and both
    engines run panels; the one merge is repro's."""
    fp32 = SimPEEngine("mp-fp32-1", SIM_ENGINE_SPECS["F-PE"])
    int8 = _SlowInt8(fp32, name="mp-int8-1")
    a, w = _ab(24 * 16, 40, 24, seed=5)
    seen = {}
    with SynergyRuntime([fp32, int8], name="i32", device="cpu") as rt:
        orig = rt._submit_jobs

        def spy(jobset, units, merge, affinity, stealable=True, **kw):
            seen["stealable"] = stealable
            return orig(jobset, units, merge, affinity, stealable, **kw)

        rt._submit_jobs = spy
        fut = _split(rt, a, w, job_class="decode")
        y = fut.result(TIMEOUT)
    assert seen["stealable"] is True
    assert set(fut.accounting) == {fp32.name, int8.name}
    assert rel_err(y, a @ w) < 0.05
    jfp32 = jax_get_engine("F-PE")
    jint8 = JaxQuantizedEngine(jfp32, name="jax-mp-int8")
    jjs = JaxJobSet.for_gemm(0, a.shape[0], 24, 40, 16)
    with JaxSynergyRuntime([jfp32, jint8], name="jax-i32") as rt:
        jy = rt.submit_gemm(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()),
                            jobset=jjs, tile=(16, 16, 16),
                            job_class="decode").result(TIMEOUT)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_decode_split_is_deterministic_over_three_runs():
    fp32, int8 = _mixed_pool(seed=2)
    a, w = _ab(12 * 16, 32, 16, seed=6)
    outs = []
    for trial in range(3):
        # one calibrator state for every run: a live EMA moves per batch
        int8.calibrator.reset()
        with SynergyRuntime([fp32, int8], name=f"det{trial}",
                            device="cpu") as rt:
            outs.append(_split(rt, a, w, job_class="decode").result(TIMEOUT))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_plain_split_on_a_mixed_pool_is_full_precision_and_pinned():
    """No job class: panels seed only onto fp32 workers (precision is
    opt-in), are not stealable, and launch no int8 kernel."""
    fp32, int8 = _mixed_pool(seed=3)
    a, w = _ab(10 * 16, 40, 24, seed=14)
    ref = fp32.execute(a, w)
    seen = {}
    with SynergyRuntime([fp32, int8], name="optin", device="cpu") as rt:
        assert rt._mixed_precision_pool()
        orig = rt._seed_locked

        def spy(jobs, affinity):
            for j in jobs:
                seen.setdefault(j.sub.future.jobset.name, j.stealable)
            return orig(jobs, affinity)

        rt._seed_locked = spy
        y_plain = _split(rt, a, w).result(TIMEOUT)
        fut = _split(rt, a, w, job_class="decode")
        fut.result(TIMEOUT)
    torch.testing.assert_close(y_plain, ref, rtol=1e-6, atol=1e-6)
    assert list(seen.values()) == [False]     # the decode split is stealable
    assert int8.name in fut.accounting


def test_mixed_pool_merges_partials_in_fp32():
    fp32, int8 = _mixed_pool(seed=1)
    a, w = _ab(8 * 16, 32, 16, seed=9)
    with SynergyRuntime([fp32, int8], name="bf16", device="cpu") as rt:
        y = _split(rt, a.to(torch.bfloat16), w.to(torch.bfloat16)).result(
            TIMEOUT)
    assert y.dtype == torch.bfloat16
    assert _rel(y, a @ w) < 0.1


class _SlowFp32(Engine):
    """Deterministic slow fp32 engine: keeps its queue populated long
    enough for mid-run pool changes to act on queued panels."""

    def __init__(self, name, delay_s=0.01):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE},
                         cost=CostModel(macs_per_s=1e9))
        self._delay_s = delay_s

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        import time
        time.sleep(self._delay_s)
        return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def test_int8_hotplug_never_quantizes_inflight_fp32_panels():
    slow = _SlowFp32("hp-fp32")
    fast_int8 = QuantizedEngine(get_engine("torch"), name="hp-int8")
    a, w = _ab(24 * 16, 32, 16, seed=16)
    with SynergyRuntime([slow], device="cpu") as rt:
        fut = _split(rt, a, w)
        rt.add_engine(fast_int8)          # rebalance while panels queued
        y = fut.result(120)
        assert "hp-int8" not in fut.accounting
    torch.testing.assert_close(y, a @ w, rtol=1e-6, atol=1e-6)


def test_the_one_worker_int8_split_equals_the_mixed_split():
    """Whichever engine runs a panel, the int32 panels and hence the merge
    are the same bits: a pool of one int8 worker against the mixed pool,
    from one calibrator state."""
    fp32, int8 = _mixed_pool(seed=5)
    a, w = _ab(20 * 16, 48, 24, seed=18)
    outs = []
    for pool in ([fp32, int8], [int8]):
        int8.calibrator.reset()
        with SynergyRuntime(pool, device="cpu") as rt:
            outs.append(_split(rt, a, w, job_class="decode",
                               affinity=pool[0].name).result(TIMEOUT))
    assert torch.equal(outs[0], outs[1])


def test_observe_acts_false_leaves_the_calibrator_alone():
    fp32, int8 = _mixed_pool(seed=6)
    a, w = _ab(4 * 16, 32, 16, seed=19)
    int8.calibrator.observe_amax(3.0, (32, 16))
    with SynergyRuntime([fp32, int8], device="cpu") as rt:
        _split(rt, a, w, job_class="decode",
               observe_acts=False).result(TIMEOUT)
        assert int8.calibrator.state()[(32, 16)].updates == 1
        _split(rt, a, w, job_class="decode").result(TIMEOUT)
        assert int8.calibrator.state()[(32, 16)].updates == 2
