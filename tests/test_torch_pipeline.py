"""The port's inter-frame pipeline (``core/pipeline.py``) against repro's on
the CPU: the mailbox pipeline's order, overlap and failure drain, the GPipe
microbatch oracle, ``EngineStage.gemm`` pinned to ``cuda-tiled`` (its plain
version on CPU tensors), CIFAR_Alex+ split into the three pinned stages
that ``chip_smoke.py``'s pipeline phase runs (``cnn.PIPE_STAGES``),
and a pipeline under a runtime scope.

Inputs are numpy arrays from a seed, handed to both packages.  Tolerances:
1e-6 for the GPipe oracle (the same elementwise ops), 1e-5 for one GEMM,
1e-4 for CNN logits (five GEMMs summed in another order)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core import pipeline as jax_pipeline
from repro.models import cnn as jax_cnn
from repro.soc import SynergyRuntime as JaxSynergyRuntime
from repro_torch.configs import PAPER_CNNS
from repro_torch.core import (EngineStage, PipelineStageError,
                              ThreadedPipeline, gpipe_reference)
from repro_torch.engines import get_engine
from repro_torch.models import cnn
from repro_torch.soc import SynergyRuntime

TIMEOUT = 30


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------- the mailbox pipeline

def test_threaded_pipeline_order_and_outputs():
    stages = [("a", lambda x: x + 1), ("b", lambda x: x * 2),
              ("c", lambda x: x - 3)]
    pipe = ThreadedPipeline(stages, mailbox_capacity=2)
    outs, stats = pipe.run(list(range(20)))
    want, _ = jax_pipeline.ThreadedPipeline(
        stages, mailbox_capacity=2).run(list(range(20)))
    assert outs == want == [(i + 1) * 2 - 3 for i in range(20)]
    assert stats["fps"] > 0
    assert set(stats["stage_utilization"]) == {"a", "b", "c"}
    assert stats["runtime"] is None and stats["stage_engines"] == {}


def test_threaded_pipeline_overlaps_stages():
    """With two equal slow stages, pipelined wall time ~ 1x stage time
    per frame (not 2x) once the pipe is full."""
    dt = 0.01

    def slow(x):
        time.sleep(dt)
        return x

    pipe = ThreadedPipeline([("s1", slow), ("s2", slow)])
    n = 20
    t0 = time.perf_counter()
    outs, _ = pipe.run(list(range(n)))
    wall = time.perf_counter() - t0
    assert len(outs) == n
    assert wall < n * 2 * dt * 0.8   # clearly better than serial


def test_raising_stage_does_not_deadlock():
    """A stage exception drains the pipe and re-raises, well before any
    deadlock timeout; the pipeline class is not poisoned."""
    def boom(x):
        if x == 5:
            raise ValueError("frame 5 is cursed")
        return x

    pipe = ThreadedPipeline([("pre", lambda x: x), ("boom", boom),
                             ("post", lambda x: x * 2)],
                            mailbox_capacity=2)
    t0 = time.perf_counter()
    with pytest.raises(PipelineStageError, match="boom") as ei:
        pipe.run(list(range(20)))
    assert isinstance(ei.value.__cause__, ValueError)
    assert time.perf_counter() - t0 < 10.0
    pipe2 = ThreadedPipeline([("ok", lambda x: x + 1)])
    outs, _ = pipe2.run([1, 2, 3])
    assert outs == [2, 3, 4]


def test_raising_first_frame_and_multiple_failures():
    """Even frame 0 failing (nothing ever reaches the sink) and repeated
    failures must drain cleanly; the FIRST failure is reported, as in
    repro."""
    calls = []

    def always(x):
        calls.append(x)
        raise ZeroDivisionError(f"frame {x}")

    pipe = ThreadedPipeline([("always", always)])
    with pytest.raises(PipelineStageError, match="always") as ei:
        pipe.run(list(range(8)))
    assert str(ei.value) == "stage 'always' raised ZeroDivisionError: frame 0"
    assert calls == list(range(8))
    with pytest.raises(jax_pipeline.PipelineStageError) as jei:
        jax_pipeline.ThreadedPipeline([("always", always)]).run(
            list(range(8)))
    assert str(jei.value) == str(ei.value)


# ------------------------------------------------- the GPipe oracle

def test_gpipe_reference_matches_repro():
    params = [1.5, -0.5, 2.0]
    mb = _np(0, 4, 8)
    got = gpipe_reference(lambda p, x: torch.tanh(x * p), params,
                          torch.from_numpy(mb))
    want = jax_pipeline.gpipe_reference(
        lambda p, x: jnp.tanh(x * p), [jnp.float32(p) for p in params],
        jnp.asarray(mb))
    assert got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------- engine stages

def test_engine_stage_gemm_pinned_matches_repro():
    """``EngineStage.gemm`` pinned to ``cuda-tiled`` (K1's plain version
    on CPU tensors) against repro's pinned to ``pallas`` (interpret mode),
    frame by frame, through both pipelines."""
    w, bias = _np(1, 48, 32), _np(2, 32)
    frames = [_np(10 + i, 64, 48) for i in range(3)]
    k1 = get_engine("cuda-tiled").telemetry
    before = k1.gemms
    stage = EngineStage.gemm("mm", torch.from_numpy(w),
                             bias=torch.from_numpy(bias),
                             activation=torch.relu, tile=32,
                             engine="cuda-tiled")
    outs, stats = ThreadedPipeline([stage]).run(
        [torch.from_numpy(f) for f in frames])
    jstage = jax_pipeline.EngineStage.gemm(
        "mm", jnp.asarray(w), bias=jnp.asarray(bias),
        activation=jax.nn.relu, tile=32, engine="pallas")
    want, _ = jax_pipeline.ThreadedPipeline([jstage]).run(
        [jnp.asarray(f) for f in frames])
    assert stats["stage_engines"] == {"mm": "cuda-tiled"}
    assert k1.gemms - before == len(frames)
    for got, ref in zip(outs, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_alex_three_stage_split_matches_repro_forward():
    """CIFAR_Alex+ (4 frames, 2 micro-batches of 2) through
    ``cnn.PIPE_STAGES``, three stages pinned to K1, K3 and K1: the
    concatenated logits match repro's ``cnn_forward``."""
    cfg, jcfg = PAPER_CNNS["CIFAR_Alex+"], JAX_CNNS["CIFAR_Alex+"]
    jparams = jax_cnn.init_cnn(jcfg, jax.random.key(0))
    params = cnn.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, device="cpu")
    x = _np(3, 4, jcfg.input_hw, jcfg.input_hw, jcfg.cin)
    want = jax_cnn.cnn_forward(jcfg, jparams, jnp.asarray(x))
    engines = {n: get_engine(n).telemetry for n in ("cuda-tiled",
                                                     "neon-vpu")}
    before = {n: t.gemms for n, t in engines.items()}
    outs, stats = ThreadedPipeline(
        cnn.pipeline_stages(cfg, params, cnn.PIPE_STAGES)).run(
        list(torch.from_numpy(x).split(2)))
    got = torch.cat(outs)
    assert got.shape == (4, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert stats["stage_engines"] == {n: e for n, _, _, e in cnn.PIPE_STAGES}
    per_mb = {n: sum(cnn.stage_gemms(cfg, lo, hi)
                     for _, lo, hi, e in cnn.PIPE_STAGES if e == n)
              for n in engines}
    assert {n: t.gemms - before[n] for n, t in engines.items()} == {
        "cuda-tiled": 2 * per_mb["cuda-tiled"],
        "neon-vpu": 2 * per_mb["neon-vpu"]} == {"cuda-tiled": 8,
                                                 "neon-vpu": 2}


@pytest.mark.parametrize("how", ["inherited", "explicit"])
def test_pipeline_under_a_runtime_reports_its_stats(how):
    """Stage GEMMs split across the runtime's pool, whether the pipeline
    inherits the caller's scope or is handed the runtime; the stats carry
    ``rt.stats()`` with repro's job counts, and the values match repro's
    pipeline under its own runtime within 1e-5."""
    w = _np(4, 40, 24)
    frames = [_np(20 + i, 96, 40) for i in range(4)]
    stages = [EngineStage.gemm("mm", torch.from_numpy(w), tile=16,
                               engine="cuda-tiled"),
              ("post", lambda y: y * 1.0)]
    jstages = [jax_pipeline.EngineStage.gemm("mm", jnp.asarray(w), tile=16,
                                             engine="pallas"),
               ("post", lambda y: y * 1.0)]
    with SynergyRuntime(["F-PE", "cuda-tiled", "neon-vpu"], name=how,
                        device="cpu") as rt:
        tframes = [torch.from_numpy(f) for f in frames]
        if how == "inherited":
            with rt.scope():
                outs, stats = ThreadedPipeline(stages).run(tframes)
        else:
            outs, stats = ThreadedPipeline(stages, runtime=rt).run(tframes)
    with JaxSynergyRuntime(["F-PE", "S-PE"], name=how) as jrt:
        want, jstats = jax_pipeline.ThreadedPipeline(
            jstages, runtime=jrt).run([jnp.asarray(f) for f in frames])
    st, jst = stats["runtime"], jstats["runtime"]
    assert st is not None and st["submissions"] == len(frames)
    assert st["submissions"] == jst["submissions"]
    assert st["total_jobs"] == jst["total_jobs"]
    assert st["total_jobs"] == len(frames) * (96 // 16) * 2
    for y, ref in zip(outs, want):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
