"""The port's qmm wrapper (K2) against repro's qmm on the same numpy
inputs, and mirrors of tests/test_qmm.py.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held against it on the card (chip_smoke.py, tests/test_torch_cuda.py).
Tolerances: the raw int32 accumulator is BITWISE repro's (integer sums are
exact); so is the fused output for no activation and ReLU, because both
round ``acc * scale + bias`` once (repro's epilogue is contracted into one
FMA by XLA, the port's plain version emulates fmaf exactly).  SiLU is
computed by two different formulas: 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.qmm import qmm_matmul as jax_qmm_matmul
from repro.kernels.qmm import qmm_ref as jax_qmm_ref
from repro.quant import dequant_finish as jax_dequant_finish
from repro.quant import quantize_weights as jax_quantize_weights
from repro.quant.act import one_shot_act_scale as jax_one_shot
from repro.quant.act import quantize_activations as jax_quantize_acts
from repro_torch.kernels.qmm import qmm_matmul, qmm_ref
from repro_torch.kernels.qmm.ref import fma_f32
from repro_torch.quant import (dequant_finish, quant_gemm,
                               quantize_weights)
from repro_torch.quant.act import one_shot_act_scale, quantize_activations


def _operands(m, k, n, seed=0, wscale=0.05):
    """The same quantized operands on both sides: (jax, torch) of
    (a, a_q, qw, act_scale, bias)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * wscale).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    ja, jw, jb = jnp.asarray(a), jnp.asarray(w), jnp.asarray(bias)
    ta, tw, tb = (torch.from_numpy(x) for x in (a, w, bias))
    js, ts = jax_one_shot(ja), one_shot_act_scale(ta)
    return ((ja, jax_quantize_acts(ja, js), jax_quantize_weights(jw), js, jb),
            (ta, quantize_activations(ta, ts), quantize_weights(tw), ts, tb))


# ------------------------------------------------------- conformance

@pytest.mark.parametrize("shape", [(16, 32, 24),    # tile-aligned
                                   (33, 70, 45),    # borders everywhere
                                   (1, 129, 17),    # single-token decode
                                   (130, 75, 10),   # conv0's k, fc7's n
                                   # the borders of the card kernel's
                                   # tiles (32-row panels, 32 x 32 and
                                   # 128 x 64 blocks, k steps of 64) and
                                   # of its two paths (k, n % 16)
                                   (1, 75, 10), (31, 33, 63), (129, 31, 65),
                                   (32, 1, 1), (127, 64, 64),
                                   # every operand at -128 or 127
                                   (127, 75, 10, "saturated"),
                                   (33, 64, 65, "saturated")])
def test_raw_accumulator_is_bitwise_repro(shape):
    m, k, n = shape[:3]
    (_, ja_q, jqw, _, _), (_, ta_q, tqw, _, _) = _operands(m, k, n, seed=1)
    tw_q, tw_scale = tqw.q, tqw.scale
    jw_q, jw_scale = jqw.q, jqw.scale
    if shape[3:] == ("saturated",):
        rng = np.random.default_rng(10)
        a_np = rng.choice(np.array([-128, 127], np.int8), size=(m, k))
        w_np = rng.choice(np.array([-128, 127], np.int8), size=(k, n))
        ta_q, tw_q = torch.from_numpy(a_np), torch.from_numpy(w_np)
        ja_q, jw_q = jnp.asarray(a_np), jnp.asarray(w_np)
    np.testing.assert_array_equal(ta_q.numpy(), np.asarray(ja_q))
    acc = qmm_matmul(ta_q, tw_q, tw_scale, fuse_dequant=False)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    jax_acc = jax_qmm_matmul(ja_q, jw_q, jw_scale, fuse_dequant=False,
                             tile=(16, 16, 16), interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax_acc))
    np.testing.assert_array_equal(
        qmm_ref(ta_q, tw_q, tw_scale, fuse_dequant=False).numpy(),
        np.asarray(jax_qmm_ref(ja_q, jw_q, jw_scale, fuse_dequant=False)))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("acts", [(None, None), (torch.relu, jax.nn.relu)],
                         ids=["none", "relu"])
@pytest.mark.parametrize("out_dtype", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_fused_output_is_bitwise_repro(with_bias, acts, out_dtype):
    """repro's CPU path (the jitted exact oracle) rounds the epilogue as
    one FMA; the port's plain version emulates fmaf, so the bits agree."""
    (_, ja_q, jqw, js, jb), (_, ta_q, tqw, ts, tb) = _operands(
        257, 1600, 64, seed=2)
    y = qmm_matmul(ta_q, tqw.q, tqw.scale, act_scale=ts,
                   bias=tb if with_bias else None, activation=acts[0],
                   out_dtype=out_dtype[0])
    jax_y = jax_qmm_matmul(ja_q, jqw.q, jqw.scale, act_scale=js,
                           bias=jb if with_bias else None,
                           activation=acts[1], out_dtype=out_dtype[1])
    assert y.dtype == out_dtype[0]
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jax_y.astype(jnp.float32)))


def test_fused_silu_and_the_pallas_interpreter_agree_closely():
    (_, ja_q, jqw, js, jb), (_, ta_q, tqw, ts, tb) = _operands(
        33, 70, 45, seed=3)
    y = qmm_matmul(ta_q, tqw.q, tqw.scale, act_scale=ts, bias=tb,
                   activation=F.silu)
    jax_y = jax_qmm_matmul(ja_q, jqw.q, jqw.scale, act_scale=js, bias=jb,
                           activation=jax.nn.silu, tile=(16, 16, 16),
                           interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_y),
                               rtol=1e-6, atol=1e-6)


def test_fma_emulation_rounds_once():
    """fma_f32 is fmaf: against exact rational arithmetic on random
    float32 triples, including cancelling ones."""
    from fractions import Fraction
    rng = np.random.default_rng(4)
    x = rng.standard_normal(3000).astype(np.float32)
    y = rng.standard_normal(3000).astype(np.float32)
    z = np.concatenate([rng.standard_normal(1500).astype(np.float32),
                        -(x[1500:] * y[1500:])])    # near-total cancellation
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(z)).numpy()
    for i in range(0, 3000, 7):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(
            float(z[i]))
        c = np.float32(float(exact))
        cands = [np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32))
                                         & 1))
        assert got[i] == best, (i, got[i], best)


def test_merge_tail_is_bitwise_repro():
    """dequant_finish (the runtime's merge) rounds each step, in repro and
    in the port alike."""
    (_, ja_q, jqw, js, jb), (_, ta_q, tqw, ts, tb) = _operands(
        64, 300, 40, seed=5)
    acc = qmm_matmul(ta_q, tqw.q, tqw.scale, fuse_dequant=False)
    jax_acc = jax_qmm_matmul(ja_q, jqw.q, jqw.scale, fuse_dequant=False)
    y = dequant_finish(acc, tqw, act_scale=ts, bias=tb,
                       activation=torch.relu, out_dtype=torch.float32)
    jax_y = jax_dequant_finish(jax_acc, jqw, act_scale=js, bias=jb,
                               activation=jax.nn.relu, out_dtype=jnp.float32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jax_y))


def test_wrapper_checks_operands():
    a = torch.zeros(4, 8, dtype=torch.int8)
    w = torch.zeros(8, 3, dtype=torch.int8)
    s = torch.ones(1, 3)
    with pytest.raises(TypeError, match="int8"):
        qmm_matmul(a.float(), w, s)
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        qmm_matmul(a, torch.zeros(7, 3, dtype=torch.int8), s)
    with pytest.raises(ValueError, match="w_scale"):
        qmm_matmul(a, w, torch.ones(1, 4))
    with pytest.raises(ValueError, match="several devices"):
        qmm_matmul(a, w.to("meta"), s)
    with pytest.raises(ValueError, match="bias"):
        qmm_matmul(a, w, s, bias=torch.ones(5))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    (_, _, _, _, _), (_, ta_q, tqw, ts, _) = _operands(8, 16, 8, seed=6)
    before = qmm_matmul.launches
    qmm_matmul(ta_q, tqw.q, tqw.scale, act_scale=ts)
    assert qmm_matmul.launches == before


# ------------------------------------------- mirrors of tests/test_qmm.py

def test_qmm_close_to_fp32_reference():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 48)) * 0.05)
                         .astype(np.float32))
    qw, s = quantize_weights(w), one_shot_act_scale(a)
    y = qmm_matmul(quantize_activations(a, s), qw.q, qw.scale, act_scale=s)
    ref = a @ w
    rel = float((y - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.05, rel


def test_raw_int32_partials_merge_to_fused_output():
    """The runtime's split mode: per-panel int32 accumulators stack to the
    exact whole-GEMM accumulator, and one merge matches the fused call to
    epilogue-rounding precision."""
    (_, _, _, _, _), (_, ta_q, tqw, ts, tb) = _operands(32, 24, 16, seed=8)
    parts = [qmm_matmul(ta_q[r0:r0 + 8].contiguous(), tqw.q, tqw.scale,
                        fuse_dequant=False) for r0 in range(0, 32, 8)]
    assert all(p.dtype == torch.int32 for p in parts)
    whole = qmm_matmul(ta_q, tqw.q, tqw.scale, fuse_dequant=False)
    assert torch.equal(torch.cat(parts, 0), whole)
    fused = qmm_matmul(ta_q, tqw.q, tqw.scale, act_scale=ts, bias=tb,
                       activation=torch.relu)
    merged = dequant_finish(torch.cat(parts, 0), tqw, act_scale=ts, bias=tb,
                            activation=torch.relu, out_dtype=torch.float32)
    torch.testing.assert_close(fused, merged, rtol=1e-5, atol=1e-6)


def test_quant_gemm_fast_path_accepts_batched_activations():
    rng = np.random.default_rng(9)
    w = torch.from_numpy((rng.standard_normal((32, 16)) * 0.05)
                         .astype(np.float32))
    a3 = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    qw = quantize_weights(w)
    y = quant_gemm(a3, qw, act_scale=one_shot_act_scale(a3))
    assert y.shape == (2, 4, 16)
    ref = torch.einsum("bmk,kn->bmn", a3, w)
    rel = float((y - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.05, rel


def test_out_dtype_and_saturation():
    """8 * 127 * 127 accumulates exactly in int32 (no int8 overflow), and
    -128 is taken as an operand."""
    y = qmm_matmul(torch.full((4, 8), 127, dtype=torch.int8),
                   torch.full((8, 4), 127, dtype=torch.int8),
                   torch.ones(1, 4), act_scale=1.0,
                   out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert float(y[0, 0]) == pytest.approx(8 * 127 * 127, rel=1e-2)
    acc = qmm_matmul(torch.full((2, 8), -128, dtype=torch.int8),
                     torch.full((8, 3), -128, dtype=torch.int8),
                     torch.ones(3), fuse_dequant=False)
    assert int(acc[0, 0]) == 8 * 128 * 128
