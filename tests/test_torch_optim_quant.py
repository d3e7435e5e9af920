"""The port's weight-only int8 param-tree quantization (``optim/quant.py``)
on the CPU: the three tests of tests/test_quant.py on the port, and its
``quantize_params`` tree bitwise equal to repro's for a reduced granite
and a reduced zamba2, each on repro's own parameters (carried across by
``lm_params_from_jax``)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import init_model as j_init_model
from repro.optim.quant import quantize_params as j_quantize_params
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import init_model, lm_params_from_jax
from repro_torch.optim.quant import (dequantize_weight, quant_matmul,
                                     quantize_params, quantize_weight)
from repro_torch.tree import tree_leaves


def _normal(seed, shape, scale=1.0):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape)
                        * scale, dtype=torch.float32)


def test_roundtrip_error_bound():
    w = _normal(0, (64, 32), 0.1)
    q, s = quantize_weight(w)
    deq = dequantize_weight(q, s, dtype=torch.float32)
    # symmetric per-channel int8: |err| <= scale/2 per element
    assert float((deq - w).abs().max()) <= float(s.max()) / 2 + 1e-6


def test_quant_matmul_close_to_fp():
    x = _normal(1, (8, 64)).to(torch.bfloat16)
    w = _normal(2, (64, 32), 0.05)
    q, s = quantize_weight(w)
    y_q = quant_matmul(x, q, s)
    y_f = (x.float() @ w).to(torch.bfloat16)
    rel = float((y_q.float() - y_f.float()).abs().max()
                / (y_f.float().abs().max() + 1e-6))
    assert rel < 0.05, rel


def test_quantize_params_walks_model():
    cfg = reduced(ARCHS["granite-3-2b"])
    params = init_model(cfg, 0, device="cpu")
    qp = quantize_params(params)
    # attention weights quantized; norms untouched
    blk = qp["blocks"]
    assert isinstance(blk["attn"]["wq"], dict)
    assert blk["attn"]["wq"]["q"].dtype == torch.int8
    assert blk["ln1"].dtype != torch.int8
    # int8 payload ~4x smaller than fp32 for the quantized leaves
    orig = params["blocks"]["attn"]["wq"]
    quant = blk["attn"]["wq"]
    nbytes = lambda t: t.numel() * t.element_size()
    assert nbytes(quant["q"]) + nbytes(quant["scale"]) < 0.3 * nbytes(orig)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


@pytest.mark.parametrize("name,n_layers", [("granite-3-2b", 2),
                                           ("zamba2-2.7b", 4)])
def test_quantize_params_is_bitwise_repro(name, n_layers):
    jcfg = j_reduced(J_ARCHS[name], n_layers=n_layers)
    jp = j_init_model(jcfg, jax.random.key(0))
    want = jax.tree.map(np.asarray, j_quantize_params(jp))
    got = quantize_params(lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    assert _paths(got) == _paths(want)
    assert any(p.endswith("/q") for p in _paths(got))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)
