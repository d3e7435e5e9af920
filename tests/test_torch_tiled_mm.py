"""The port's tiled_mm wrapper and plain version against repro's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held against it on the card (chip_smoke.py, tests/test_torch_cuda.py).
Tolerances follow tests/test_tiled_mm.py: fp32 1e-5, bf16 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.tiled_mm import tiled_matmul as jax_tiled_matmul
from repro.kernels.tiled_mm import tiled_mm_ref as jax_tiled_mm_ref
from repro_torch.kernels.tiled_mm import ops, tiled_matmul, tiled_mm_ref

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _operands(seed, m, n, k, dtype="float32", bias=False):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((m, k), (k, n), (n,))]
    jdt, tdt, _ = _DTYPES[dtype]
    jax_ops = [jnp.asarray(x).astype(jdt) for x in arrays[:2]]
    torch_ops = [torch.from_numpy(x).to(tdt) for x in arrays[:2]]
    if bias:
        jax_ops.append(jnp.asarray(arrays[2]))
        torch_ops.append(torch.from_numpy(arrays[2]))
    else:
        jax_ops.append(None)
        torch_ops.append(None)
    return jax_ops, torch_ops


def _close(port, ref, tol):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 128, 96),
                                   (70, 45, 33), (1, 257, 129),
                                   (130, 1, 31)])
def test_matches_jax_kernel_and_oracle(shape, dtype):
    m, n, k = shape
    (ja, jb, _), (ta, tb, _) = _operands(0, m, n, k, dtype)
    tol = _DTYPES[dtype][2]
    y = tiled_matmul(ta, tb)
    assert y.dtype == ta.dtype and y.shape == (m, n)
    jax_y = jax_tiled_matmul(ja, jb, tile=32, interpret=True)
    _close(y, jax_y, tol)
    _close(tiled_mm_ref(ta, tb), jax_tiled_mm_ref(ja, jb), tol)


@pytest.mark.parametrize("tile", [8, 16, 32, (16, 32, 16)])
def test_result_is_independent_of_the_jax_tile(tile):
    """The port's kernel has one fixed block tile; every job tile of the
    reference gives the same GEMM."""
    (ja, jb, jbias), (ta, tb, tbias) = _operands(1, 70, 45, 33, bias=True)
    y = tiled_matmul(ta, tb, bias=tbias, activation=torch.relu)
    jax_y = jax_tiled_matmul(ja, jb, bias=jbias, activation=jax.nn.relu,
                             tile=tile, interpret=True)
    _close(y, jax_y, 1e-5)


@pytest.mark.parametrize("acts", [(None, None), (torch.relu, jax.nn.relu),
                                  (F.silu, jax.nn.silu),
                                  (torch.tanh, jnp.tanh)],
                         ids=["none", "relu", "silu", "unfused-tanh"])
def test_fused_epilogue(acts):
    t_act, j_act = acts
    (ja, jb, jbias), (ta, tb, tbias) = _operands(2, 48, 56, 40, bias=True)
    y = tiled_matmul(ta, tb, bias=tbias, activation=t_act)
    _close(y, jax_tiled_matmul(ja, jb, bias=jbias, activation=j_act,
                               tile=(16, 32, 16), interpret=True), 1e-5)
    _close(tiled_mm_ref(ta, tb, bias=tbias, activation=t_act),
           jax_tiled_mm_ref(ja, jb, bias=jbias, activation=j_act), 1e-5)


@pytest.mark.parametrize("dtypes", [("bfloat16", "float32"),
                                    ("float32", "bfloat16")])
def test_out_dtype(dtypes):
    in_dt, out_dt = dtypes
    (ja, jb, _), (ta, tb, _) = _operands(3, 33, 17, 65, in_dt)
    y = tiled_matmul(ta, tb, out_dtype=_DTYPES[out_dt][1])
    assert y.dtype == _DTYPES[out_dt][1]
    jax_y = jax_tiled_matmul(ja, jb, tile=32, out_dtype=_DTYPES[out_dt][0],
                             interpret=True)
    assert jax_y.dtype == _DTYPES[out_dt][0]
    _close(y, jax_y, 3e-2)


@pytest.mark.parametrize("case", ["shape", "dtype-mix", "int", "strided",
                                  "bias-length", "out-dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a = torch.ones(8, 4)
    b = torch.ones(4, 6)
    kwargs = {}
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
        tiled_matmul(a, b, **kwargs)


def test_cuda_tensor_launches_or_raises_never_plain(monkeypatch):
    """A CUDA tensor never takes the plain version: without a card (or a
    CUDA toolkit) the wrapper raises.  Fake tensors stand in for CUDA
    tensors on a machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs (test_torch_cuda)")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args, **kwargs):
        raise AssertionError("plain version reached for a CUDA tensor")

    monkeypatch.setattr(ops, "tiled_mm_ref", plain)
    before = tiled_matmul.launches
    with FakeTensorMode():
        a = torch.empty(8, 4, device="cuda")
        b = torch.empty(4, 6, device="cuda")
        assert a.device.type == "cuda"
        with pytest.raises(RuntimeError):
            tiled_matmul(a, b)
    assert tiled_matmul.launches == before
