"""The port's job decomposition, engine registry, dispatcher and tracer
against repro's: copied modules agree exactly, and dispatch decisions map
through ENGINE_NAME_MAP (xla -> torch, pallas -> cuda-tiled)."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.engines as jax_engines
from repro.core.job import JobSet as JaxJobSet
from repro.engines import dispatch_gemm as jax_dispatch_gemm
from repro.obs.trace import Tracer as JaxTracer
from repro.obs.trace import chrome_trace as jax_chrome_trace
from repro_torch.core.job import JobSet
from repro_torch.core.synergy_mm import SynergyTrace, synergy_matmul
from repro_torch.engines import (CAP_EPILOGUE, CAP_GEMM, CAP_GRAD,
                                 ENGINE_NAME_MAP, SIM_ENGINE_SPECS, CostModel,
                                 Engine, Telemetry, dispatch_gemm,
                                 get_engine, list_engines, registered)
from repro_torch.obs.trace import Tracer, chrome_trace, trace_scope

_GEMMS = [(0, 262144, 64, 75, 32), (1, 70, 45, 33, (16, 32, 16)),
          (2, 1, 257, 129, 8), (3, 0, 10, 128, 32), (4, 4096, 4096, 4096,
                                                     (256, 256, 256))]
_CONVS = [(0, 256, 32, 32, 3, 64, 5, 1, 2, 32), (1, 2, 28, 28, 1, 32, 5, 1,
                                                 2, 32),
          (2, 4, 9, 7, 2, 8, 3, 2, 1, (8, 16, 8))]


def _fields(js):
    return (dataclasses.astuple(js), js.grid, js.num_jobs, js.k_steps,
            js.total_macs, js.useful_macs, js.padding_waste,
            [dataclasses.astuple(j) for j in list(js.jobs())[:3]])


@pytest.mark.parametrize("args", _GEMMS)
def test_jobset_for_gemm_equals_reference(args):
    layer, m, n, k, tile = args
    ours = JobSet.for_gemm(layer, m, n, k, tile, name="g")
    theirs = JaxJobSet.for_gemm(layer, m, n, k, tile, name="g")
    assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("args", _CONVS)
def test_jobset_for_conv_equals_reference(args):
    *geom, tile = args
    ours = JobSet.for_conv(*geom, tile=tile, name="c")
    theirs = JaxJobSet.for_conv(*geom, tile=tile, name="c")
    assert _fields(ours) == _fields(theirs)


def test_registry_maps_through_the_name_table():
    ours = {e.name: e for e in list_engines()}
    for jax_eng in jax_engines.list_engines():
        if jax_eng.name == "neon-vpu":      # waits for kernel K3
            assert "neon-vpu" not in ENGINE_NAME_MAP
            continue
        if jax_eng.name not in ENGINE_NAME_MAP:
            continue                        # registered by another test
        eng = ours[ENGINE_NAME_MAP[jax_eng.name]]
        assert eng.capabilities == jax_eng.capabilities, jax_eng.name
    assert set(ENGINE_NAME_MAP.values()) <= set(ours)


def test_sim_engines_equal_reference():
    assert list(SIM_ENGINE_SPECS) == list(jax_engines.SIM_ENGINE_SPECS)
    for kind, cost in SIM_ENGINE_SPECS.items():
        ref = jax_engines.SIM_ENGINE_SPECS[kind]
        assert dataclasses.astuple(cost) == dataclasses.astuple(ref)
        assert get_engine(kind).cost == cost
        js = JobSet.for_gemm(0, 300, 70, 75, 32)
        assert get_engine(kind).estimate(js) == (
            jax_engines.get_engine(kind).estimate(
                JaxJobSet.for_gemm(0, 300, 70, 75, 32)))


@pytest.mark.parametrize("job_class", [None, "prefill", "train", "decode"])
@pytest.mark.parametrize("args", _GEMMS)
def test_cpu_dispatch_maps_xla_to_torch(args, job_class):
    layer, m, n, k, tile = args
    theirs = jax_dispatch_gemm(JaxJobSet.for_gemm(layer, m, n, k, tile),
                               job_class=job_class)
    ours = dispatch_gemm(JobSet.for_gemm(layer, m, n, k, tile),
                         job_class=job_class, device=torch.device("cpu"))
    assert theirs.name == "xla"
    assert ours.name == ENGINE_NAME_MAP[theirs.name] == "torch"


@pytest.mark.parametrize("args", [g for g in _GEMMS if g[1]])
def test_cuda_operands_rank_the_kernel_first(args):
    """Ranking keys on the operands' device (no card needed to rank): the
    hand-written kernel wins on CUDA tensors, the oracle never wins."""
    layer, m, n, k, tile = args
    js = JobSet.for_gemm(layer, m, n, k, tile)
    assert dispatch_gemm(js, device=torch.device("cuda")).name == "cuda-tiled"
    assert dispatch_gemm(js, device=torch.device("cuda"),
                         job_class="train").name == "torch"


class _GradFreeMock(Engine):
    """Implausibly fast engine without CAP_GRAD: auto-dispatch would pick
    it for every GEMM unless the grad guard keeps it off."""

    def __init__(self, name="gradfree-mock"):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE},
                         cost=CostModel(1e18))
        self.calls = 0

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        self.calls += 1
        return torch.matmul(a, b)


def _ab(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32)))


def test_grad_operand_gets_a_grad_engine():
    a, b = _ab(0)
    mock = _GradFreeMock()
    with registered(mock):
        synergy_matmul(a, b, tile=8)
        assert mock.calls == 1              # ranks first without autograd
        a.requires_grad_()
        tr = SynergyTrace()
        with tr.activate():
            y = synergy_matmul(a, b, tile=8)
        assert mock.calls == 1
        assert set(tr.engine_stats) == {"torch"}
        assert CAP_GRAD in get_engine("torch").capabilities
        y.sum().backward()
        torch.testing.assert_close(a.grad, b.sum(1).expand(8, 12))
        with torch.no_grad():
            synergy_matmul(a, b, tile=8)
        assert mock.calls == 2              # grad off: the guard is off


def test_grad_trace_rejects_explicit_kernel_pin():
    a, b = _ab(1)
    a.requires_grad_()
    with pytest.raises(ValueError, match="grad"):
        synergy_matmul(a, b, tile=8, engine="cuda-tiled")


def test_dispatch_decisions_reach_the_tracer():
    a, b = _ab(2)
    tracer = Tracer()
    with trace_scope(tracer):
        synergy_matmul(a, b, tile=8, name="traced")
    events = [e for e in tracer.events() if e.kind == "dispatch"]
    assert [(e.track, e.tags["jobset"]) for e in events] == [
        ("torch", "traced")]


def test_tracer_export_equals_reference():
    ours, theirs = Tracer(), JaxTracer()
    for tr in (ours, theirs):
        tr.emit("dispatch", "torch", ts=0.5, jobset="j")
        tr.span("panel", "F-PE", ts=1.0, dur=0.25, jobset="p")
        tr.emit("steal", "S-PE", ts=2.0, victim="F-PE")
    a, b = chrome_trace(ours.events()), jax_chrome_trace(theirs.events())
    a.pop("otherData"), b.pop("otherData")
    assert a == b


def test_telemetry_record_equals_reference():
    from repro.engines import Telemetry as JaxTelemetry
    ours, theirs = Telemetry(), JaxTelemetry()
    ours.record(JobSet.for_gemm(0, 300, 70, 75, 32), 0.5)
    theirs.record(JaxJobSet.for_gemm(0, 300, 70, 75, 32), 0.5)
    fields = [f.name for f in dataclasses.fields(Telemetry)
              if f.name != "_lock"]
    assert ([getattr(ours, f) for f in fields]
            == [getattr(theirs, f) for f in fields])
