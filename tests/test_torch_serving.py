"""The port's continuous-batching server (``repro_torch.core.serving``)
against ``repro``'s on the CPU.

Every scenario of ``tests/test_serving.py`` runs on both servers over the
same reduced config, with ``repro``'s weights carried across (the LM
params through ``lm_params_from_jax``, the prefill CNN's through
``params_from_jax``, the proxy decode weight as an array), and checks:

* each request's tokens are equal;
* the ``ServeStats`` counters are equal (waves, steps, chunks, stalls,
  ``runtime_jobs``, ``precision_jobs``, rejections, shed steps);
* the decode-GEMM outputs are within 1e-5 in fp32 and bitwise once the
  int8 scale is published;
* within the port, what ``repro``'s test asserts of ``repro``: batched
  decode bitwise per-slot, wave tokens equal single tokens, chunked
  equal to blocking (the caches included).

``repro``'s servers share one jitted ``decode_step`` per config (the
same function each server jits for itself), so the reference costs one
compile per shape rather than one per server.  Engines that must stall
are gated on ``threading.Event``s, never on sleeps; the chunked conv
chain is stepped against its own chunk futures, so its interleave is the
same on both servers whatever the load.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core import serving as jax_serving
from repro.engines import CAP_EPILOGUE as J_CAP_EPILOGUE
from repro.engines import CAP_GEMM as J_CAP_GEMM
from repro.engines import CAP_GRAD as J_CAP_GRAD
from repro.engines import CostModel as JaxCostModel
from repro.engines import Engine as JaxEngine
from repro.engines import get_engine as jax_get_engine
from repro.models import decode_step as jax_decode_step
from repro.models import init_model as jax_init_model
from repro.models.cnn import CNNConfig as JaxCNNConfig
from repro.quant import QuantizedEngine as JaxQuantizedEngine
from repro.soc import SynergyRuntime as JaxRuntime
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import serving
from repro_torch.core.job import JobSet
from repro_torch.core.serving import (PrefillJob, Request, ServeTimeoutError,
                                      SynergyServer)
from repro_torch.engines import (CAP_EPILOGUE, CAP_GEMM, CAP_GRAD,
                                 ENGINE_NAME_MAP, CostModel, Engine,
                                 get_engine)
from repro_torch.models import lm_params_from_jax
from repro_torch.models.cnn import CNNConfig, conv_jobsets, params_from_jax
from repro_torch.quant import QuantizedEngine
from repro_torch.soc import GraphCancelled, SynergyRuntime

TIMEOUT = 60
FP32_TOL = 1e-5

_TINY_LAYERS = (("conv", 4, 3, 1, 1), ("pool", 2),
                ("conv", 8, 3, 1, 1), ("fc", 10))
#: a tiny conv front-end (MNIST topology at a fraction of the MACs) for
#: scenarios that run the REAL conv-as-GEMM prefill chain on sim engines
TINY_CNN = CNNConfig(name="tiny", input_hw=8, cin=1, layers=_TINY_LAYERS)
JAX_TINY_CNN = JaxCNNConfig(name="tiny", input_hw=8, cin=1,
                            layers=_TINY_LAYERS)

GRANITE = ("granite-3-2b", (("n_layers", 2), ("d_model", 32),
                            ("n_heads", 2), ("d_ff", 64), ("vocab", 128)))
MAMBA = ("mamba2-130m", (("n_layers", 2), ("d_model", 32), ("vocab", 128)))

#: ServeStats counters that are the same on any run of one scenario
COUNTERS = ("engine_steps", "prefills", "prefill_waves", "decode_steps",
            "tokens_out", "inflight_peak", "prefill_chunks",
            "decode_stall_steps", "precision_jobs", "runtime_jobs",
            "runtime_retries", "admission_rejects", "shed_engagements",
            "shed_degraded_steps")
TENANT_COUNTERS = ("admitted", "rejected", "prefills", "tokens_out",
                   "deadline_hits", "deadline_misses", "degraded_steps")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _model(arch: str, kw: tuple):
    """(repro cfg, port cfg, repro params, the same params on the port)."""
    jcfg = jax_reduced(JAX_ARCHS[arch], **dict(kw))
    cfg = reduced(ARCHS[arch], **dict(kw))
    jp = jax_init_model(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, lm_params_from_jax(_np_tree(jp), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    """The jitted ``decode_step`` a repro server builds for itself."""
    return jax.jit(lambda p, c, t, pos: jax_decode_step(jcfg, p, c, t, pos))


def servers(slots=2, model=GRANITE, *, max_len=32, prefill_len=4,
            cnn=None, jax_kw=(), torch_kw=(), **kw):
    """A repro server and a port server on the same config and weights;
    ``kw`` goes to both, ``jax_kw``/``torch_kw`` to one side."""
    jcfg, cfg, jp, tp = _model(*model)
    jcnn, tcnn = ((JAX_TINY_CNN, TINY_CNN) if cnn == "tiny"
                  else (None, None))
    js = jax_serving.SynergyServer(
        jcfg, jp, slots=slots, max_len=max_len, prefill_len=prefill_len,
        prefill_cnn=jcnn, **kw, **dict(jax_kw))
    js._decode = _jax_decode(jcfg)
    ts = SynergyServer(
        cfg, tp, slots=slots, max_len=max_len, prefill_len=prefill_len,
        prefill_cnn=tcnn,
        cnn_params=params_from_jax(_np_tree(js._cnn_params), "cpu"),
        decode_weight=torch.from_numpy(np.array(js._decode_w)),
        device="cpu", **kw, **dict(torch_kw))
    return js, ts


def requests(n, toks=lambda i: np.arange(4) + i, max_new=5, tenant=None,
             base=0):
    """The same n requests for each server: (repro's, the port's)."""
    jr, tr = [], []
    for i in range(n):
        t = np.asarray(toks(i), np.int32)
        new = max_new(i) if callable(max_new) else max_new
        jr.append(jax_serving.Request(base + i, jnp.asarray(t), new,
                                      tenant=tenant))
        tr.append(Request(base + i, torch.from_numpy(t.copy()), new,
                          tenant=tenant))
    return jr, tr


def submit_all(srv, reqs):
    for r in reqs:
        srv.submit(r)


def outs(reqs):
    return [list(r.out) for r in reqs]


def assert_same_stats(js, ts):
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.tenants.keys() == js.tenants.keys()
    for tname, tst in ts.tenants.items():
        for name in TENANT_COUNTERS:
            assert getattr(tst, name) == getattr(js.tenants[tname], name), \
                (tname, name)


def assert_decode_outputs_close(jouts, touts, bitwise_from=None):
    """The port's decode-GEMM outputs against repro's: within 1e-5, and
    bitwise from step ``bitwise_from`` on (the int8-calibrated steps)."""
    assert len(touts) == len(jouts) > 0
    for i, (ja, ta) in enumerate(zip(jouts, touts)):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape
        np.testing.assert_allclose(ta, ja, rtol=FP32_TOL, atol=FP32_TOL)
        if bitwise_from is not None and i >= bitwise_from:
            assert np.array_equal(ta, ja), f"decode step {i}"


def serve_both(js, ts, n=5, **req_kw):
    jr, tr = requests(n, **req_kw)
    submit_all(js, jr)
    submit_all(ts, tr)
    jst, tst = js.run(), ts.run()
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, tst)
    return jr, tr, jst, tst


def _bitwise(outs_a, outs_b):
    assert len(outs_a) == len(outs_b) > 0
    for a, b in zip(outs_a, outs_b):
        assert a.shape == b.shape
        assert torch.equal(a, b)


# ----------------------------------------------------------- the basics

def test_all_requests_complete():
    js, ts = servers(slots=2)
    _, reqs, _, stats = serve_both(
        js, ts, toks=lambda i: np.asarray(
            jax.random.randint(jax.random.key(i), (4,), 0, 128)))
    assert all(len(r.out) >= 5 for r in reqs), [len(r.out) for r in reqs]
    assert stats.prefills == 5
    assert not ts.pending
    assert all(s is None for s in ts.slot_req)


def test_continuous_batching_overlaps_requests():
    js, ts = servers(slots=2)
    _, _, _, stats = serve_both(js, ts, n=4, max_new=6)
    assert stats.slot_efficiency > 1.0, stats


def test_engine_idle_returns_false():
    js, ts = servers()
    assert ts.step() is False
    assert js.step() is False


def _staggered(srv, prompt, other, req_cls, arr):
    """A is admitted, decodes two steps, then B arrives mid-generation."""
    ra = req_cls(0, arr(prompt), max_new_tokens=8)
    srv.submit(ra)
    srv.step()                       # prefill A
    srv.step()
    srv.step()                       # 2 decode steps
    rb = req_cls(1, arr(other), max_new_tokens=8)
    srv.submit(rb)                   # admitted mid-generation
    srv.run()
    return ra, rb


def test_prefill_does_not_corrupt_live_requests():
    """Prefill writes only the target slot: a request's tokens are the
    same with or without a mid-generation admission, as in repro."""
    prompt = np.asarray(jax.random.randint(jax.random.key(7), (4,), 0, 128))
    other = np.asarray(jax.random.randint(jax.random.key(9), (4,), 0, 128))
    js, ts = servers(slots=2)
    jr, tr = requests(1, toks=lambda i: prompt, max_new=8)
    submit_all(ts, tr)
    submit_all(js, jr)
    ts.run()
    js.run()
    js2, ts2 = servers(slots=2)
    ja, jb = _staggered(js2, prompt, other, jax_serving.Request, jnp.asarray)
    ta, tb = _staggered(ts2, prompt, other, Request,
                        lambda t: torch.tensor(np.asarray(t), dtype=torch.int32))
    assert ta.out == tr[0].out, "another request's prefill changed A"
    assert len(tb.out) >= 8
    assert (ta.out, tb.out) == (ja.out, jb.out)
    assert tr[0].out == jr[0].out


def test_decode_uses_per_slot_positions():
    """A request's tokens do not depend on its slot's admission order."""
    def late(srv, req_cls, arr):
        filler = req_cls(7, arr(np.arange(4) + 3), max_new_tokens=3)
        srv.submit(filler)
        srv.step()
        srv.step()
        srv.step()
        r2 = req_cls(0, arr(np.arange(4)), max_new_tokens=6)
        srv.submit(r2)
        srv.run()
        return r2

    js, ts = servers(slots=2)
    jr, tr = requests(1, toks=lambda i: np.arange(4), max_new=6)
    submit_all(js, jr)
    submit_all(ts, tr)
    js.run()
    ts.run()
    js2, ts2 = servers(slots=2)
    j2 = late(js2, jax_serving.Request,
              lambda t: jnp.asarray(np.asarray(t, np.int32)))
    t2 = late(ts2, Request,
              lambda t: torch.tensor(np.asarray(t), dtype=torch.int32))
    assert t2.out == tr[0].out
    assert (t2.out, tr[0].out) == (j2.out, jr[0].out)


def test_prefill_does_not_corrupt_live_ssm_state():
    """Bystander slots' Mamba state is masked during prefill, and a reused
    slot's state is reset, on the port's in-place caches as in repro."""
    arr_t = lambda t: torch.tensor(np.asarray(t), dtype=torch.int32)  # noqa: E731
    js, ts = servers(slots=2, model=MAMBA)
    jr, tr = requests(1, toks=lambda i: np.arange(4), max_new=6)
    submit_all(js, jr)
    submit_all(ts, tr)
    js.run()
    ts.run()

    def staggered(srv, req_cls, arr):
        rb = req_cls(0, arr(np.arange(4)), max_new_tokens=6)
        srv.submit(rb)
        srv.step()
        srv.step()
        srv.step()
        srv.submit(req_cls(1, arr(np.arange(4) + 7), max_new_tokens=6))
        srv.run()
        return rb

    js2, ts2 = servers(slots=2, model=MAMBA)
    jb = staggered(js2, jax_serving.Request,
                   lambda t: jnp.asarray(np.asarray(t, np.int32)))
    tb = staggered(ts2, Request, arr_t)
    assert tb.out == tr[0].out
    assert (tb.out, tr[0].out) == (jb.out, jr[0].out)

    # slot reuse: 3 identical prompts through 2 slots; the third (reused
    # slot) must decode the same tokens as the first
    js3, ts3 = servers(slots=2, model=MAMBA)
    _, reqs, _, _ = serve_both(js3, ts3, n=3, toks=lambda i: np.arange(4))
    assert reqs[2].out == reqs[0].out


def test_serving_jobs_route_through_dispatcher():
    js, ts = servers(slots=2)
    _, _, jst, stats = serve_both(js, ts, n=3, max_new=4)
    assert stats.job_engine.keys() == {"prefill", "decode"}
    assert stats.job_busy_s["prefill"] > 0
    assert stats.job_busy_s["decode"] > 0
    assert stats.job_engine == {k: ENGINE_NAME_MAP[v]
                                for k, v in jst.job_engine.items()}
    assert stats.job_busy_s == pytest.approx(jst.job_busy_s, rel=1e-12)


# ------------------------------------------------------- admission waves

def test_wave_admission_admits_min_pending_free():
    """N pending requests + M free slots admit min(N, M) in ONE step."""
    js, ts = servers(slots=3)
    jr, tr = requests(5, max_new=4)
    submit_all(js, jr)
    submit_all(ts, tr)
    for srv in (js, ts):
        assert srv.step() is True
        assert srv.stats.prefills == 3          # min(5 pending, 3 free)
        assert srv.stats.prefill_waves == 1
        assert len(srv.pending) == 2
        assert all(r is not None for r in srv.slot_req)
        srv.step()                              # no free slot: decode
        assert srv.stats.prefills == 3
        assert srv.stats.decode_steps == 1
    jst, stats = js.run(), ts.run()
    assert stats.prefills == 5
    assert stats.prefill_waves <= 3
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, stats)


def test_single_admission_mode_admits_one_per_step():
    js, ts = servers(slots=3, admission="single")
    jr, tr = requests(3, max_new=4)
    submit_all(js, jr)
    submit_all(ts, tr)
    ts.step()
    js.step()
    assert ts.stats.prefills == js.stats.prefills == 1
    jst, stats = js.run(), ts.run()
    assert stats.prefills == 3
    assert stats.prefill_waves == 3
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, stats)


def test_wave_admission_outputs_match_single_admission():
    """Batching the admission wave changes no request's tokens."""
    toks = lambda i: np.arange(4) * (i + 1) % 128  # noqa: E731
    js, ts = servers(slots=2)
    jr, wave = serve_both(js, ts, n=4, toks=toks, max_new=6)[:2]
    js1, ts1 = servers(slots=2, admission="single")
    single = serve_both(js1, ts1, n=4, toks=toks, max_new=6)[1]
    assert outs(wave) == outs(single) == outs(jr)


def _pools(engines, name):
    return (JaxRuntime(engines, name=name),
            SynergyRuntime(engines, name=name, device="cpu"))


def test_wave_slot_reuse_stays_corruption_free():
    """3 identical prompts through 2 slots over a runtime: the third rides
    a reused slot of a second wave and decodes the same tokens."""
    jrt, trt = _pools(["F-PE", "S-PE"], "reuse")
    with jrt, trt:
        js, ts = servers(slots=2, cnn="tiny", jax_kw={"runtime": jrt},
                         torch_kw={"runtime": trt})
        _, reqs, _, _ = serve_both(js, ts, n=3, toks=lambda i: np.arange(4))
    assert reqs[2].out == reqs[0].out
    assert reqs[1].out == reqs[0].out


# ------------------------------------------------- real conv-as-GEMM prefill

def test_prefill_jobsets_are_real_conv_shapes():
    """The wave's JobSets are the conv-as-GEMM shapes of the CNN, equal
    to repro's, and exactly what ``conv_jobsets`` exports to the DES."""
    job = PrefillJob(wave=1, rids=(0, 1), slots=(0, 1), n_frames=8,
                     cnn=TINY_CNN)
    jjob = jax_serving.PrefillJob(wave=1, rids=(0, 1), slots=(0, 1),
                                  n_frames=8, cnn=JAX_TINY_CNN)
    jss = job.jobsets()
    shape = lambda js: (js.name, js.m, js.n, js.k, js.grid)  # noqa: E731
    assert [shape(js) for js in jss] == [shape(js) for js in jjob.jobsets()]
    assert [shape(js) for js in jss] == [shape(js) for _, js in
                                         conv_jobsets(TINY_CNN, 8,
                                                      name_prefix="prefill/w1/")]
    assert (jss[0].m, jss[0].n, jss[0].k) == (8 * 8 * 8, 4, 9)
    assert all(js.k != _model(*GRANITE)[1].d_model for js in jss)


def test_prefill_busy_seconds_match_conv_cost_model():
    """Prefill busy-seconds are the conv cost model's estimate of the
    wave's jobsets, on the runtime and the dispatcher path, equal to
    repro's."""
    def expected_busy(eng, n_frames):
        return sum(eng.estimate(js, "cpu")
                   for _, js in conv_jobsets(TINY_CNN, n_frames))

    jrt, trt = _pools(["F-PE"], "busy")
    with jrt, trt:
        js, ts = servers(slots=2, cnn="tiny", jax_kw={"runtime": jrt},
                         torch_kw={"runtime": trt})
        _, _, jst, stats = serve_both(js, ts, n=2, max_new=2)
    exp = expected_busy(get_engine("F-PE"), n_frames=8)
    assert stats.job_busy_s["prefill"] == pytest.approx(exp, rel=1e-6)
    assert stats.job_busy_s == pytest.approx(jst.job_busy_s, rel=1e-12)

    js2, ts2 = servers(slots=2, cnn="tiny")
    _, _, jst2, stats2 = serve_both(js2, ts2, n=1, max_new=2)
    eng = ts2.dispatcher.select(
        PrefillJob(1, (0,), (0,), 4, TINY_CNN).jobsets()[0],
        job_class="prefill", device="cpu")
    exp2 = expected_busy(eng, n_frames=4)
    assert stats2.job_busy_s["prefill"] == pytest.approx(exp2, rel=1e-6)
    assert stats2.job_busy_s == pytest.approx(jst2.job_busy_s, rel=1e-12)


def test_wave_prefill_gathers_im2col_once_per_layer(monkeypatch):
    """ONE im2col gather per conv layer covers the whole admission wave,
    through the serving module's own ``im2col_wave`` reference."""
    calls = []
    real = serving.im2col_wave

    def counting(x, *a, **kw):
        calls.append(int(x.shape[0]))
        return real(x, *a, **kw)

    monkeypatch.setattr(serving, "im2col_wave", counting)
    jcalls = []
    jreal = jax_serving.im2col_wave

    def jcounting(x, *a, **kw):
        jcalls.append(int(x.shape[0]))
        return jreal(x, *a, **kw)

    monkeypatch.setattr(jax_serving, "im2col_wave", jcounting)
    jrt, trt = _pools(["F-PE", "S-PE"], "gather")
    with jrt, trt:
        js, ts = servers(slots=3, cnn="tiny", jax_kw={"runtime": jrt},
                         torch_kw={"runtime": trt})
        jr, tr = requests(3, max_new=2)
        submit_all(js, jr)
        submit_all(ts, tr)
        assert ts.step() is True       # one wave admits all 3
        assert js.step() is True
        ts.drain()
        js.drain()
    n_conv = sum(1 for spec in TINY_CNN.layers if spec[0] == "conv")
    assert len(calls) == n_conv        # NOT 3 * n_conv
    assert calls[0] == 12              # 3 requests x 4 frames, one batch
    assert calls == jcalls


def test_wave_frames_are_repro_frames():
    """The conv front-end's input: each prompt token's embedding row tiled
    into a frame, as repro builds it."""
    js, ts = servers(cnn="tiny")
    toks = np.arange(5, dtype=np.int32) * 7
    got = ts._wave_frames(torch.from_numpy(toks))
    want = np.asarray(js._wave_frames(jnp.asarray(toks)))
    assert got.shape == want.shape == (5, 8, 8, 1)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------- coalesced decode: bitwise

def _run_decode_mode(mode, engines, n_req=3, **server_kw):
    """One decode mode on both servers over the same pool: (port requests,
    port stats, port decode outputs, repro's requests, stats, outputs)."""
    jeng, teng = engines
    jrt = JaxRuntime(jeng, name=f"bitwise-{mode}")
    trt = SynergyRuntime(teng, name=f"bitwise-{mode}", device="cpu")
    with jrt, trt:
        kw = dict(decode_mode=mode, keep_decode_outputs=True,
                  max_inflight=1, **server_kw)
        js, ts = servers(slots=2, cnn="tiny", jax_kw={"runtime": jrt},
                         torch_kw={"runtime": trt}, **kw)
        jr, tr = requests(n_req)
        submit_all(js, jr)
        submit_all(ts, tr)
        jst, tst = js.run(), ts.run()
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, tst)
    return (tr, tst, ts.decode_gemm_outputs, jr, jst,
            js.decode_gemm_outputs)


def test_batched_decode_bitwise_identical_fp32():
    """The coalesced decode submission is BITWISE the per-slot loop on the
    fp32 path, and each mode is within 1e-5 of repro's."""
    ra, sa, outs_a, _, _, jouts_a = _run_decode_mode(
        "batched", (["F-PE", "S-PE"],) * 2)
    rb, sb, outs_b, _, _, jouts_b = _run_decode_mode(
        "per-slot", (["F-PE", "S-PE"],) * 2)
    assert outs(ra) == outs(rb)
    assert sa.decode_steps == sb.decode_steps
    assert len(outs_a) == sa.decode_steps and len(outs_b) == sb.decode_steps
    _bitwise(outs_a, outs_b)
    assert_decode_outputs_close(jouts_a, outs_a)
    assert_decode_outputs_close(jouts_b, outs_b)
    assert sa.runtime_jobs < sb.runtime_jobs


def test_batched_decode_bitwise_identical_int8_calibrated():
    """Same bitwise identity on the int8-calibrated path; both modes feed
    the calibrator once per step at reap, so the scale trajectories — and
    the int8 outputs — equal each other's and repro's.  The port's int8
    engine wraps the tile engine, as ``register_quantized("cuda-tiled")``
    does on the card: its warm-up steps (weight-only, before a scale is
    published) run the tile kernel's path, whose rows do not depend on m,
    where the ``torch`` engine's BLAS GEMM picks its algorithm by m."""
    def pools(tag):
        return ([JaxQuantizedEngine(jax_get_engine("xla"),
                                    name=f"bw-int8-{tag}")],
                [QuantizedEngine(get_engine("cuda-tiled"),
                                 name=f"bw-int8-{tag}")])

    pa = pools("batched")
    ra, sa, outs_a, _, jsa, jouts_a = _run_decode_mode("batched", pa)
    pb = pools("per-slot")
    rb, sb, outs_b, _, _, jouts_b = _run_decode_mode("per-slot", pb)
    qa, qb = pa[1][0], pb[1][0]
    assert outs(ra) == outs(rb)
    cfg = _model(*GRANITE)[1]
    key = (cfg.d_model, cfg.n_layers * 2 * cfg.d_ff)
    assert qa.calibrator.state()[key].updates == sa.decode_steps
    assert qb.calibrator.state()[key].updates == sb.decode_steps
    assert qa.calibrator.state()[key].amax \
        == qb.calibrator.state()[key].amax \
        == pa[0][0].calibrator.state()[key].amax
    assert qa.act_scale_for(*key) is not None
    _bitwise(outs_a, outs_b)
    # step t submits before step t-1 is reaped (max_inflight=1): from
    # step 2 on the scale is published and the int32-partial path runs
    assert_decode_outputs_close(jouts_a, outs_a, bitwise_from=2)
    assert_decode_outputs_close(jouts_b, outs_b, bitwise_from=2)
    assert sa.precision_jobs["int8"] > 0
    assert sa.precision_jobs == jsa.precision_jobs


# --------------------------------------------------- async in-flight window

def test_inflight_window_overlaps_and_orders_completions():
    jrt, trt = _pools(["F-PE", "S-PE"], "window")
    with jrt, trt:
        js, ts = servers(slots=2, cnn="tiny", max_inflight=4,
                         jax_kw={"runtime": jrt}, torch_kw={"runtime": trt})
        _, _, _, stats = serve_both(js, ts, n=4, max_new=4)
        assert trt.stats()["total_jobs"] == stats.runtime_jobs
    assert stats.inflight_peak > 1
    assert not ts._inflight
    assert stats.runtime_jobs > 0


class _Gated:
    """Every panel waits on ``gate`` (a ``threading.Event``), so a tiny
    ``submit_timeout`` trips while the prefill graph's first GEMM is
    queued; ``entered`` is set once a panel waits there; ``ran`` counts
    the panels that executed."""

    def _init_gate(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.ran = 0

    def _wait(self):
        self.entered.set()
        assert self.gate.wait(TIMEOUT), "gate never opened"
        self.ran += 1


class _GatedEngine(_Gated, Engine):
    def __init__(self, name="gated"):
        Engine.__init__(self, name, {CAP_GEMM, CAP_EPILOGUE, CAP_GRAD},
                        cost=CostModel(macs_per_s=1e9))
        self._init_gate()

    def execute(self, a, b, *, bias=None, activation=None,
                tile=(256, 256, 256), out_dtype=None):
        self._wait()
        y = a.float() @ b.float()
        if bias is not None:
            y = y + bias
        if activation is not None:
            y = activation(y)
        return y.to(out_dtype or a.dtype)


class _JaxGatedEngine(_Gated, JaxEngine):
    def __init__(self, name="gated"):
        JaxEngine.__init__(self, name, {J_CAP_GEMM, J_CAP_EPILOGUE,
                                        J_CAP_GRAD},
                           cost=JaxCostModel(macs_per_s=1e9))
        self._init_gate()

    def execute(self, a, b, *, bias=None, activation=None,
                tile=(256, 256, 256), out_dtype=None, precision=None):
        self._wait()
        y = jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32))
        if bias is not None:
            y = y + bias
        if activation is not None:
            y = activation(y)
        return y.astype(out_dtype or a.dtype)


def _timed_out(srv, req, rt, eng, error=ServeTimeoutError):
    """Run ``srv`` until the gated pool ``eng`` trips its submit_timeout;
    returns the error and the prefill graph the server submitted.  A
    decode GEMM is submitted only once a prefill panel waits at the gate,
    so it queues behind that panel however slowly the graph's host-side
    gather runs."""
    captured = {}
    orig, orig_gemm = rt.submit_graph, rt.submit_gemm

    def capture(*a, **kw):
        captured["gf"] = orig(*a, **kw)
        return captured["gf"]

    def after_prefill(*a, **kw):
        if kw["jobset"].name.startswith("decode/"):
            assert eng.entered.wait(TIMEOUT), "no prefill panel started"
        return orig_gemm(*a, **kw)

    rt.submit_graph = capture
    rt.submit_gemm = after_prefill
    srv.submit(req)
    with pytest.raises(error) as ei:
        srv.run()
    return ei.value, captured["gf"]


def _gated_sides(name):
    """(engine, runtime, server, request) for repro and for the port, each
    server over a one-engine gated pool with a 10 ms submit_timeout."""
    jeng, teng = _JaxGatedEngine(), _GatedEngine()
    jrt = JaxRuntime([jeng], name=name)
    trt = SynergyRuntime([teng], name=name, device="cpu")
    js, ts = servers(slots=1, cnn="tiny", submit_timeout=0.01,
                     jax_kw={"runtime": jrt}, torch_kw={"runtime": trt})
    jr, tr = requests(1, toks=lambda i: np.arange(4), max_new=2)
    return ((jeng, jrt, js, jr[0], jax_serving.ServeTimeoutError),
            (teng, trt, ts, tr[0], ServeTimeoutError))


def test_submit_timeout_surfaces_serve_timeout_error():
    """The timeout is a constructor arg, and tripping it raises
    ServeTimeoutError naming the jobset, as in repro."""
    errors = []
    for eng, rt, srv, req, error in _gated_sides("slowpool"):
        with rt:
            try:
                errors.append(_timed_out(srv, req, rt, eng, error)[0])
            finally:
                eng.gate.set()
    jerr, err = errors
    assert "prefill/w1" in str(err)
    assert err.timeout == jerr.timeout == 0.01
    assert err.rids == jerr.rids == (0,)
    assert err.jobset_name == jerr.jobset_name


def test_timeout_cancels_graph_and_drains_queues():
    """Tripping submit_timeout on a prefill graph CANCELS it: downstream
    nodes never launch and the GEMM's queued panels are drained, so the
    pool holds only the decode GEMM's panel behind the one in flight, and
    once the gate opens fresh work runs after just those two — on repro's
    server and the port's alike."""
    queued_conv = PrefillJob(1, (0,), (0,), 4, TINY_CNN).jobsets()[0]
    assert queued_conv.grid[0] > 2
    for eng, rt, srv, req, error in _gated_sides("slowpool2"):
        with rt:
            try:
                _, gf = _timed_out(srv, req, rt, eng, error)
                assert rt.stats()["engines"]["gated"]["queued"] == 1
            finally:
                eng.gate.set()
            with pytest.raises((GraphCancelled, RuntimeError)):
                gf.result(TIMEOUT)
            states = gf.node_states()
            assert "cancelled" in states       # downstream never started
            assert states[-1] == "cancelled"
            if isinstance(eng, _GatedEngine):
                fresh = rt.submit_gemm(
                    torch.ones(16, 32), torch.ones(32, 16),
                    jobset=JobSet.for_gemm(9, 16, 16, 32, 16, name="fresh"),
                    tile=(16, 16, 16))
            else:
                from repro.core.job import JobSet as JaxJobSet
                fresh = rt.submit_gemm(
                    jnp.ones((16, 32)), jnp.ones((32, 16)),
                    jobset=JaxJobSet.for_gemm(9, 16, 16, 32, 16,
                                              name="fresh"),
                    tile=(16, 16, 16))
            fresh.result(TIMEOUT)
            # the conv panel in flight, the decode panel, the fresh one
            assert eng.ran == 3


# ------------------------------------------------------- chunked prefill

def _cache_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _cache_equal(a[k], b[k])
    else:
        assert torch.equal(a, b)


def test_chunked_prefill_interleaves_decode_and_matches_blocking():
    """With ``prefill_chunk_macs`` set, admission interleaves with decode
    (no stalled decode step) and every token — and the final caches — are
    identical to the blocking admission, on both servers alike."""
    def run(**kw):
        js, ts = servers(slots=2, **kw)
        jr, tr, jst, tst = serve_both(js, ts, n=4,
                                      max_new=lambda i: 3 + i)
        return outs(tr), tst, ts

    outs_blk, st_blk, srv_blk = run()
    outs_chk, st_chk, srv_chk = run(prefill_chunk_macs=20_000)
    assert outs_chk == outs_blk                     # bitwise token parity
    _cache_equal(srv_chk.cache, srv_blk.cache)
    assert st_chk.prefill_chunks > 0
    assert st_chk.decode_stall_steps == 0
    assert st_blk.prefill_chunks == 0
    assert st_blk.decode_stall_steps > 0
    assert st_chk.prefills == st_blk.prefills == 4


def _run_lockstep(srv):
    """``run()``, but every outstanding conv chunk graph lands before the
    next step (the chain then advances one chunk per step on any load)."""
    while True:
        prog = srv._progress
        conv = prog.conv if prog is not None else None
        if conv is not None and conv.fut is not None:
            conv.fut.result(TIMEOUT)
        if not srv.step():
            break
    srv.drain()
    return srv.stats


def test_chunked_conv_graph_chunks_through_runtime():
    """The wave's conv front-end splits into bounded-MAC graph chunks
    chained by their carry, with the same tokens as one unchunked graph
    and every conv job booked; the chain's carry is the unchunked graph's
    output."""
    def run(chunk):
        jrt, trt = _pools(["F-PE", "S-PE"], f"chunk{chunk}")
        with jrt, trt:
            js, ts = servers(slots=2, cnn="tiny", prefill_chunk_macs=chunk,
                             jax_kw={"runtime": jrt},
                             torch_kw={"runtime": trt})
            jr, tr = requests(4, max_new=lambda i: 3 + i)
            submit_all(js, jr)
            submit_all(ts, tr)
            jst, tst = _run_lockstep(js), _run_lockstep(ts)
        assert outs(tr) == outs(jr)
        assert_same_stats(jst, tst)
        return outs(tr), tst

    outs_one, st_one = run(None)
    outs_many, st_many = run(150_000)
    assert outs_many == outs_one
    assert st_many.prefill_chunks >= 4     # >= 2 conv chunks x 2 waves
    assert st_many.decode_stall_steps == 0
    assert st_many.prefills == st_one.prefills == 4
    assert st_many.runtime_jobs == st_one.runtime_jobs > 0
    assert st_many.job_busy_s["prefill"] > 0


def test_chunked_conv_carry_is_the_unchunked_output():
    """Chunk c+1's first gather reshapes chunk c's flat output: the last
    chunk's value equals the one-graph wave's, and repro's (1e-5)."""
    finals = {}
    for chunk in (None, 150_000):
        jrt, trt = _pools(["F-PE", "S-PE"], f"carry{chunk}")
        with jrt, trt:
            js, ts = servers(slots=2, cnn="tiny", prefill_chunk_macs=chunk,
                             jax_kw={"runtime": jrt},
                             torch_kw={"runtime": trt})
            got = {}
            for side, srv, rt in (("torch", ts, trt), ("jax", js, jrt)):
                orig = rt.submit_graph
                graphs = []

                def capture(*a, _orig=orig, _graphs=graphs, **kw):
                    _graphs.append(_orig(*a, **kw))
                    return _graphs[-1]

                rt.submit_graph = capture
                jr, tr = requests(2, max_new=2)
                submit_all(srv, tr if side == "torch" else jr)
                _run_lockstep(srv)
                got[side] = np.asarray(graphs[-1].result(TIMEOUT)[-1])
        np.testing.assert_allclose(got["torch"], got["jax"], rtol=FP32_TOL,
                                   atol=FP32_TOL)
        finals[chunk] = got["torch"]
    assert np.array_equal(finals[None], finals[150_000])


# ------------------------------------------------- real FFN decode weights

def test_decode_weight_stacks_real_ffn_layers():
    """Dense params expose blocks.mlp.wi: the decode weight is the REAL
    per-layer wi stacked along n — bitwise repro's."""
    js, ts = servers(slots=2)
    cfg = _model(*GRANITE)[1]
    assert ts._decode_ffn_cols == js._decode_ffn_cols == 2 * cfg.d_ff
    assert tuple(ts._decode_w.shape) == (cfg.d_model,
                                         cfg.n_layers * 2 * cfg.d_ff)
    assert np.array_equal(ts._decode_w.numpy(), np.asarray(js._decode_w))


def test_decode_weight_proxy_fallback_for_ssm():
    """Families without a dense FFN stack take the (d_model, 4·d_model)
    proxy: repro's when carried across, else a seeded draw — and serve
    end to end either way."""
    model = ("mamba2-130m", ())
    jcfg, cfg, jp, tp = _model(*model)
    js, ts = servers(slots=1, model=model, max_len=16, prefill_len=2)
    assert ts._decode_ffn_cols is None
    assert tuple(ts._decode_w.shape) == (cfg.d_model, 4 * cfg.d_model)
    assert np.array_equal(ts._decode_w.numpy(), np.asarray(js._decode_w))
    _, reqs, _, stats = serve_both(
        js, ts, n=1, toks=lambda i: np.arange(2) % cfg.vocab_size,
        max_new=2)
    assert stats.decode_steps >= 1 and len(reqs[0].out) >= 2
    drawn = SynergyServer(cfg, tp, slots=1, max_len=16, prefill_len=2,
                          device="cpu")
    again = SynergyServer(cfg, tp, slots=1, max_len=16, prefill_len=2,
                          device="cpu")
    assert torch.equal(drawn._decode_w, again._decode_w)
    assert tuple(drawn._decode_w.shape) == (cfg.d_model, 4 * cfg.d_model)
    with pytest.raises(ValueError, match="decode_weight"):
        SynergyServer(cfg, tp, slots=1, max_len=16, device="cpu",
                      decode_weight=torch.zeros(3, 3))


def test_empty_prompt_mid_wave_drops_nothing():
    """A bad request mid-wave fails BEFORE any wave member is popped."""
    js, ts = servers(slots=2)
    for srv, req_cls, arr in ((js, jax_serving.Request, jnp.asarray),
                              (ts, Request, torch.from_numpy)):
        good = req_cls(0, arr(np.arange(4, dtype=np.int32)), 3)
        bad = req_cls(1, arr(np.zeros((0,), np.int32)), 3)
        srv.submit(good)
        srv.submit(bad)
        with pytest.raises(ValueError, match="empty prompt"):
            srv.step()
        assert srv.pending and srv.pending[0] is good
        assert all(r is None for r in srv.slot_req)
        srv.pending.remove(bad)
        stats = srv.run()
        assert stats.prefills == 1 and len(good.out) >= 3
    assert ts.slot_req == js.slot_req == [None, None]


# ----------------------------------------------------- the port's own

def test_bystander_slots_stay_bitwise_untouched_by_a_wave():
    """The in-place caches: a wave's replay and its slot zeroing leave the
    live slot's rows bitwise as they were."""
    _, ts = servers(slots=2)
    tr = requests(2, max_new=8)[1]
    ts.submit(tr[0])
    ts.step()
    ts.step()
    before = {k: v[:, 0].clone() for k, v in ts.cache.items()}
    ts.submit(tr[1])
    assert ts.step() is True           # admits into slot 1 only
    assert ts.slot_req[1] is tr[1]
    for k, v in ts.cache.items():
        assert torch.equal(v[:, 0], before[k]), k


def test_durability_is_not_ported_yet():
    """Durability is ported (tests/test_torch_durable.py): a server
    without a ``Durability`` keeps no journal and no snapshots, and its
    ``snapshot()`` refuses, as repro's does."""
    js, ts = servers()
    for srv in (js, ts):
        assert srv.durable is None
        assert srv._journal is None and srv._ck is None
        with pytest.raises(RuntimeError, match="durable="):
            srv.snapshot()
    _, _, _, stats = serve_both(js, ts, n=2, max_new=3)
    assert (stats.snapshots, stats.restores, stats.replayed_tokens) \
        == (0, 0, 0)


def test_the_server_runs_on_the_card_unless_told():
    cfg, tp = _model(*GRANITE)[1], _model(*GRANITE)[3]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynergyServer(cfg, tp)
    with SynergyRuntime(["F-PE"], name="elsewhere", device="cpu") as rt:
        srv = SynergyServer(cfg, tp, device="cpu", runtime=rt)
        assert srv.device == torch.device("cpu")
        assert srv.cache["k"].device.type == "cpu"
