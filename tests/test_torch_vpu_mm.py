"""The port's vpu_mm wrapper (K3) and its NeonVpuEngine against repro's
Pallas kernel (interpret mode) and oracle, on the same numpy inputs.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held against it, and bitwise against tiled_mm, on the card (chip_smoke.py,
tests/test_torch_cuda.py).  Tolerances follow tests/test_vpu_mm.py:
rtol/atol 1e-4 for fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.engines import get_engine as jax_get_engine
from repro.kernels.vpu_mm import vpu_matmul as jax_vpu_matmul
from repro.kernels.vpu_mm import vpu_mm_ref as jax_vpu_mm_ref
from repro_torch.core.job import JobSet
from repro_torch.engines import (CAP_GEMM, CAP_GRAD, CAP_VPU, Dispatcher,
                                 NeonVpuEngine, get_engine, list_engines)
from repro_torch.kernels.vpu_mm import ops, vpu_matmul, vpu_mm_ref


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a, b, bias = (rng.standard_normal(s).astype(np.float32)
                  for s in ((m, k), (k, n), (n,)))
    return ((jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias)),
            (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias)))


def _close(port, ref, tol=1e-4):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(32, 32, 32),     # tile-aligned
                                   (33, 40, 45),     # borders everywhere
                                   (1, 129, 17)])    # decode-like row
def test_vpu_matmul_matches_the_jax_kernel(shape):
    m, k, n = shape
    (ja, jb, jbias), (ta, tb, tbias) = _operands(0, m, k, n)
    y = vpu_matmul(ta, tb, bias=tbias, activation=torch.relu)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    jax_y = jax_vpu_matmul(ja, jb, bias=jbias, activation=jax.nn.relu,
                           tile=(16, 16, 16), interpret=True)
    _close(y, jax_y)
    _close(vpu_mm_ref(ta, tb, bias=tbias, activation=torch.relu),
           jax_vpu_mm_ref(ja, jb, bias=jbias, activation=jax.nn.relu))


@pytest.mark.parametrize("acts", [(None, None), (F.silu, jax.nn.silu),
                                  (torch.tanh, jnp.tanh)],
                         ids=["none", "silu", "unfused-tanh"])
def test_epilogues_match_the_jax_kernel(acts):
    t_act, j_act = acts
    (ja, jb, jbias), (ta, tb, tbias) = _operands(1, 40, 24, 36)
    _close(vpu_matmul(ta, tb, bias=tbias, activation=t_act),
           jax_vpu_matmul(ja, jb, bias=jbias, activation=j_act,
                          tile=(8, 8, 8), interpret=True))


def test_bf16_in_fp32_out():
    (ja, jb, _), (ta, tb, _) = _operands(2, 33, 65, 17)
    y = vpu_matmul(ta.to(torch.bfloat16), tb.to(torch.bfloat16),
                   out_dtype=torch.float32)
    assert y.dtype == torch.float32
    _close(y, jax_vpu_matmul(ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16),
                             out_dtype=jnp.float32, tile=(16, 16, 16),
                             interpret=True), 3e-2)


@pytest.mark.parametrize("case", ["shape", "dtype-mix", "int", "strided",
                                  "bias-length", "out-dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a, b, kwargs = torch.ones(8, 4), torch.ones(4, 6), {}
    if case == "shape":
        b = torch.ones(5, 6)
    elif case == "dtype-mix":
        b = b.to(torch.bfloat16)
    elif case == "int":
        a, b = a.to(torch.int32), b.to(torch.int32)
    elif case == "strided":
        a = torch.ones(4, 8).t()
    elif case == "bias-length":
        kwargs["bias"] = torch.ones(5)
    else:
        kwargs["out_dtype"] = torch.float16
    with pytest.raises((ValueError, TypeError)):
        vpu_matmul(a, b, **kwargs)


def test_cuda_tensor_launches_or_raises_never_plain(monkeypatch):
    """A CUDA tensor never takes the plain version: without a card (or a
    CUDA toolkit) the wrapper raises.  Fake tensors stand in for CUDA
    tensors on a machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs (test_torch_cuda)")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args, **kwargs):
        raise AssertionError("plain version reached for a CUDA tensor")

    monkeypatch.setattr(ops, "vpu_mm_ref", plain)
    before = vpu_matmul.launches
    with FakeTensorMode():
        a = torch.empty(8, 4, device="cuda")
        b = torch.empty(4, 6, device="cuda")
        with pytest.raises(RuntimeError):
            vpu_matmul(a, b)
    assert vpu_matmul.launches == before


def test_neon_vpu_engine_registered_with_vpu_capability():
    assert "neon-vpu" in {e.name for e in list_engines()}
    eng = get_engine("neon-vpu")
    assert isinstance(eng, NeonVpuEngine)
    assert eng.supports({CAP_GEMM, CAP_VPU})
    assert not eng.supports({CAP_GRAD})
    assert eng.capabilities == jax_get_engine("neon-vpu").capabilities
    (ja, jb, _), (ta, tb, _) = _operands(3, 20, 24, 18)
    _close(eng.execute(ta, tb, tile=(16, 16, 16)), jax_vpu_mm_ref(ja, jb))


@pytest.mark.parametrize("device", ["cpu", torch.device("cuda")],
                         ids=["cpu", "cuda"])
def test_vpu_engine_never_wins_auto_dispatch(device):
    """The NEON role: it joins pools explicitly and never wins a solo GEMM,
    for operands on the CPU or on a card (a cost query; no card needed)."""
    js = JobSet.for_gemm(0, 64, 64, 64, 32)
    assert Dispatcher().select(js, device=device).name != "neon-vpu"
    assert Dispatcher().select(js, engine="neon-vpu",
                               device=device).name == "neon-vpu"
    eng = get_engine("neon-vpu")
    assert eng.cost_on(device).macs_per_s < \
        get_engine("cuda-tiled").cost_on(device).macs_per_s


def test_vpu_engine_rate_on_the_card_is_a_sixteenth_of_cuda_tiled():
    eng = get_engine("neon-vpu")
    assert eng.cost_on("cuda").macs_per_s == pytest.approx(
        get_engine("cuda-tiled").cost_on("cuda").macs_per_s / 16)
    # a custom-cost instance (benchmark pools) honors the injected model
    paperish = NeonVpuEngine("vpu-x",
                             cost=get_engine("F-PE").cost.scaled(0.42))
    assert paperish.cost_on("cuda").macs_per_s == pytest.approx(
        0.42 * get_engine("F-PE").cost.macs_per_s)
