"""The port's examples (``examples_torch/``) against ``repro`` on the CPU,
part 1: the runtime and CNN scripts (runtime_steal, trace_steals,
chaos_pool, cnn_inference, quant_zoo).

Each test loads a port script with ``importlib`` and calls its
``run(device="cpu", ...)``; ``repro``'s side is its library called as its
script (``examples/<name>.py``) calls it, on the same inputs: arrays made
with ``jax.random`` cross to the port as numpy (``params_from_jax``,
``lm_params_from_jax``).  Exact figures are compared exactly (SimRuntime
decisions, JobSet tables, the DES, routing, tile jobs, virtual-time fps,
injected faults); CNN logits within 1e-4.  Wall-clock figures are not
compared.  Nothing is written into the repo tree (``tmp_path``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core import scheduler as jax_scheduler
from repro.core.job import JobSet as JaxJobSet
from repro.core.serving import Request as JaxRequest
from repro.core.serving import SynergyServer as JaxServer
from repro.core.synergy_mm import SynergyTrace as JaxTrace
from repro.engines import Dispatcher as JaxDispatcher
from repro.engines import registered as jax_registered
from repro.engines import unregister_engine as jax_unregister
from repro.engines.sim import SIM_ENGINE_SPECS as JAX_SPECS
from repro.engines.sim import SimPEEngine as JaxSimPE
from repro.engines.vpu import NeonVpuEngine as JaxVpu
from repro.models import cnn as jax_cnn
from repro.models import init_model as jax_init_model
from repro.obs import Tracer as JaxTracer
from repro.obs import parse_prometheus as jax_parse_prometheus
from repro.obs import render_prometheus as jax_render_prometheus
from repro.obs import validate_events as jax_validate_events
from repro.quant import CalibrationError as JaxCalibrationError
from repro.quant import QuantizedEngine as JaxQuantized
from repro.quant import register_quantized as jax_register_quantized
from repro.soc import SimRuntime as JaxSimRuntime
from repro.soc import SynergyRuntime as JaxRuntime
from repro_torch.engines import ENGINE_NAME_MAP, find_engine
from repro_torch.models import lm_params_from_jax
from repro_torch.models.cnn import params_from_jax
from repro_torch.obs import load_chrome_trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the scripts' tensors are small, and more
    threads only contend with the worker threads and the other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def example(name: str):
    """``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_example(name: str):
    """``examples/<name>.py`` (``repro``'s script) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    """A nested dict of ``repro``'s arrays as writable numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


# ------------------------------------------------------------ runtime_steal

def test_runtime_steal_matches_repro():
    """SimRuntime's jobs, steals and busy fraction exactly ``repro``'s
    ({'F-PE': 14, 'S-PE': 6}, {'F-PE': 0, 'S-PE': 6}, 0.92); the
    hot-plugged pool's names ``repro``'s; the runtime's pipeline outputs
    equal the pinned run's."""
    out = example("runtime_steal").run("cpu", frames=2)
    js = JaxJobSet.for_gemm(0, 320, 48, 64, 32, name="mm")
    sim = JaxSimRuntime(["F-PE", "S-PE"]).run(js, affinity="F-PE")
    assert out["sim_jobs"] == dict(sim.per_engine_jobs) == {"F-PE": 14,
                                                             "S-PE": 6}
    assert out["sim_steals"] == dict(sim.per_engine_steals)
    assert out["sim_busy_fraction"] == sim.aggregate_busy_fraction
    assert round(out["sim_busy_fraction"], 2) == 0.92

    boosted = JaxSimPE("X-PE", JAX_SPECS["F-PE"].scaled(4.0))
    rt = JaxRuntime(["F-PE", "S-PE"], follow_registry=True,
                    name="hotplug").start()
    try:
        with jax_registered(boosted):
            hotplug = list(rt.engine_names)
        unplug = list(rt.engine_names)
    finally:
        rt.shutdown()
    assert out["hotplug_pool"] == hotplug == ["F-PE", "S-PE", "X-PE"]
    assert out["unplug_pool"] == unplug == ["F-PE", "S-PE"]
    assert out["outputs_equal"]
    assert sum(s["jobs"] for s in out["engines"].values()) == 2 * 20
    assert find_engine("X-PE") is None


# ------------------------------------------------------------- trace_steals

def _repro_trace_burst(bursts: int = 12):
    tracer = JaxTracer(capacity=100_000)
    a, b = jnp.ones((128, 32)), jnp.ones((32, 32))
    with JaxRuntime(["F-PE", "S-PE", "NEON"], name="trace-demo",
                    tracer=tracer) as rt:
        futs = [rt.submit_gemm(
            a, b, jobset=JaxJobSet.for_gemm(s, 128, 32, 32, 32,
                                            name=f"burst{s}"),
            tile=(32, 32, 32), affinity="F-PE") for s in range(bursts)]
        for f in futs:
            f.result(60)
        prom = jax_render_prometheus(runtime=rt)
    return tracer, prom


def test_trace_steals_matches_repro(tmp_path):
    """The traced burst validates with no errors on both; the kinds that
    do not depend on thread timing (seed, enqueue, panel_start/end) have
    ``repro``'s counts, every enqueued panel is dequeued by its owner or
    stolen once, every event kind is one ``repro`` records, and the
    Prometheus metric names are ``repro``'s.  The Chrome trace lands at the
    given path and loads back."""
    path = tmp_path / "trace.json"
    out = example("trace_steals").run("cpu", out_path=str(path))
    tracer, prom = _repro_trace_burst()
    events = tracer.events()
    want = dict(tracer.counts())
    assert jax_validate_events(events, engines={"F-PE", "S-PE", "NEON"}) \
        == [] == out["errors"]
    for kind in ("seed", "enqueue", "panel_start", "panel_end"):
        assert out["counts"][kind] == want[kind], kind
    assert (out["counts"]["seed"], out["counts"]["enqueue"]) == (12, 48)
    for counts in (out["counts"], want):
        assert (counts.get("dequeue", 0) + counts.get("steal", 0)
                == counts["enqueue"])
    assert set(out["kinds"]) <= {"seed", "enqueue", "dequeue", "steal",
                                 "panel_start", "panel_end"}
    assert out["metric_names"] == sorted(jax_parse_prometheus(prom))
    assert out["outputs_right"]
    assert path.exists() and len(load_chrome_trace(str(path))) \
        == out["events"]


# --------------------------------------------------------------- chaos_pool

def _reference_lines(capsys, name) -> dict:
    reference_example(name).main()
    lines = capsys.readouterr().out.splitlines()
    return {ln.split(":", 1)[0].strip(): ln.split(":", 1)[1].strip()
            for ln in lines if ":" in ln}


def test_chaos_pool_matches_repro(capsys):
    """The same faults are injected at the same calls, with ``repro``'s
    retries and worker deaths (``repro``'s script run and its printed
    lines read), and the chaos outputs are bitwise the clean run's."""
    out = example("chaos_pool").run("cpu")
    ref = _reference_lines(capsys, "chaos_pool")
    assert out["injected"] == [("cp-b", "raise", 1), ("cp-b", "raise", 2),
                               ("cp-c", "die", 4)]
    assert str(out["injected"]) == ref["injected"]
    assert out["retries"] == int(ref["panel retries"]) == 2
    assert out["worker_deaths"] == int(ref["worker deaths"]) == 1
    assert out["bitwise"]
    assert ref["outputs bitwise identical to clean run"] == "True"
    assert len(out["outputs"]) == 12
    assert all(o.shape == (256, 48) and torch.isfinite(o).all()
               for o in out["outputs"])


# ------------------------------------------------------------ cnn_inference

def test_cnn_inference_matches_repro():
    """CIFAR_full at 1 frame: the JobSet table (name, m, n, k, jobs,
    pad_waste) and the DES figures exactly ``repro``'s, the logits within
    1e-4 of ``repro``'s jitted forward on the same weights and frame, and
    the runtime's logits within 1e-4 of the dispatcher's."""
    cfg = JAX_CNNS["CIFAR_full"]
    jparams = jax_cnn.init_cnn(cfg, jax.random.key(0))
    x = jax.random.normal(jax.random.key(1),
                          (1, cfg.input_hw, cfg.input_hw, cfg.cin))
    out = example("cnn_inference").run(
        "cpu", params=params_from_jax(_np_tree(jparams), "cpu"),
        x=torch.from_numpy(np.array(x)), frames=2)
    tr = JaxTrace()
    with tr.activate():
        want = jax.jit(lambda p, xx: jax_cnn.cnn_forward(cfg, p, xx))(
            jparams, x)
    assert out["jobsets"] == [(js.name, js.m, js.n, js.k, js.num_jobs,
                               js.padding_waste) for js in tr.jobsets]
    assert (out["gemms"], out["tile_jobs"]) == (4, 45) == (
        len(tr.jobsets), tr.num_jobs)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert out["drift"] <= 1e-4
    assert out["runtime_jobs"] == 45

    net = jax_cnn.build_simnet(cfg)
    ws = jax_scheduler.simulate(net, policy="ws", frames=96)
    sf = jax_scheduler.simulate(net, policy="sf", frames=96)
    _, _, sc = jax_scheduler.search_sc(net, frames=64)
    assert out["single_thread_s"] == jax_scheduler.single_thread_latency(net)
    assert (out["ws_fps"], out["ws_utilization"]) == (ws.fps, ws.utilization)
    assert (out["sf_fps"], out["sf_utilization"]) == (sf.fps, sf.utilization)
    assert (out["sc_fps"], out["sc_utilization"]) == (sc.fps, sc.utilization)
    assert round(out["single_thread_s"] * 1e3, 1) == 89.7
    assert (round(out["ws_fps"], 1), round(out["sf_fps"], 1),
            round(out["sc_fps"], 1)) == (80.6, 77.3, 80.9)


# ---------------------------------------------------------------- quant_zoo

@pytest.fixture
def quant_inputs():
    """``repro``'s serving params, prompts and operands, as its script
    draws them."""
    jcfg = jax_reduced(JAX_ARCHS["granite-3-2b"], n_layers=2, d_model=32,
                       n_heads=2, d_ff=64, vocab=128)
    jparams = jax_init_model(jcfg, jax.random.key(0))
    prompts = [jax.random.randint(jax.random.key(i), (4,), 0, 128)
               for i in range(3)]
    ka, kb = jax.random.split(jax.random.key(3))
    life = (jax.random.normal(ka, (4, 64)),
            jax.random.normal(kb, (64, 128)) * 0.05)
    ka, kb = jax.random.split(jax.random.key(1))
    acc = (jax.random.normal(ka, (4, 64)),
           jax.random.normal(kb, (64, 256)) * 0.05)
    return jcfg, jparams, prompts, {"life": life, "acc": acc}


def test_quant_zoo_matches_repro(quant_inputs):
    """Routing through ``ENGINE_NAME_MAP``, the refusal at tol 1e-9, the
    served routes and per-precision tile jobs ({'int8': 80, 'fp32': 442})
    and the virtual-time pools' fps exactly ``repro``'s; the int8 errors
    within the calibrated tolerance."""
    jcfg, jparams, prompts, operands = quant_inputs
    out = example("quant_zoo").run(
        "cpu", params=lm_params_from_jax(_np_tree(jparams), "cpu"),
        prompts=[np.array(p, np.int32) for p in prompts],
        operands={k: tuple(torch.from_numpy(np.array(t)) for t in v)
                  for k, v in operands.items()})
    assert find_engine("torch-int8") is None       # unregistered after

    eng = jax_register_quantized("xla", tol=0.05)
    try:
        with pytest.raises(JaxCalibrationError):
            jax_register_quantized("xla", name="impossible-int8", tol=1e-9)
        js = JaxJobSet.for_gemm(0, 8, 256, 64, 32, name="decode-step")
        d = JaxDispatcher()
        routing = {str(cls): ENGINE_NAME_MAP[d.select(js, job_class=cls)
                                             .name]
                   for cls in (None, "decode", "prefill", "train")}
        srv = JaxServer(jcfg, jparams, slots=2, max_len=32, prefill_len=4)
        for i, p in enumerate(prompts):
            srv.submit(JaxRequest(i, p, max_new_tokens=6))
        stats = srv.run()
    finally:
        jax_unregister(eng.name)
    assert out["refused"].startswith("CalibrationError: refusing")
    assert out["routing"] == routing == {"None": "torch",
                                         "decode": "torch-int8",
                                         "prefill": "torch",
                                         "train": "torch"}
    assert out["served_routes"] == {k: ENGINE_NAME_MAP[v] for k, v in
                                    stats.job_engine.items()}
    assert out["precision_jobs"] == dict(stats.precision_jobs) == {
        "int8": 80, "fp32": 442}
    assert out["int8_path"] and out["scale_before"] is None
    assert out["lifecycle_rel_err"] <= 0.05 and out["int8_rel_err"] <= 0.05

    fp32 = JaxSimPE("zoo-fp32", JAX_SPECS["F-PE"])
    int8 = JaxQuantized(fp32, name="zoo-int8")
    vpu = JaxVpu("zoo-vpu", interpret=True, cost=JAX_SPECS["NEON"])
    frames = [JaxJobSet.for_gemm(i, 128, 256, 64, 32, name=f"decode{i}")
              for i in range(16)]
    for name, pool in [("fp32-only", [fp32]), ("int8-only", [int8]),
                       ("vpu-only", [vpu]), ("mixed", [fp32, int8, vpu])]:
        makespan, fracs = 0.0, 0.0
        for fjs in frames:
            res = JaxSimRuntime(pool).run(fjs)
            makespan += res.makespan_s
            fracs += res.aggregate_busy_fraction
        fps = len(frames) / makespan
        assert out["pools"][name] == (fps, fps * fracs / len(frames)), name
    assert round(out["pools"]["mixed"][0], 1) == 257.7
    assert round(out["gain"], 2) == 1.28
    assert out["vpu_matches"]
