"""The port's quantization numerics (repro_torch.quant.quantize and .act)
against repro.quant on the same numpy inputs, plus mirrors of
tests/test_act_quant.py's calibrator cases and tests/test_quant_props.py.

Everything here is held BITWISE against repro: the weight and activation
quantizers (true float32 divisions on both sides), the scales, the
ActCalibrator's EMA trajectory (Python floats on the host on both sides)
and its export/import round trip.  The property tests keep few examples."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import ActCalibrator as JaxActCalibrator
from repro.quant import dequantize_weights as jax_dequantize_weights
from repro.quant import quantization_error as jax_quantization_error
from repro.quant import quantize_weights as jax_quantize_weights
from repro.quant.act import one_shot_act_scale as jax_one_shot
from repro.quant.act import quantize_activations as jax_quantize_acts
from repro_torch.quant import (ActCalibrator, QuantizedWeight,
                               dequantize_weights, one_shot_act_scale,
                               quant_gemm, quantization_error,
                               quantize_activations, quantize_weights)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------- conformance

@pytest.mark.parametrize("shape,wscale", [((96, 40), 0.2), ((75, 64), 0.05),
                                          ((1600, 10), 3.0), ((1, 7), 1.0)])
def test_quantize_weights_is_bitwise_repro(shape, wscale):
    w = _np(0, *shape, scale=wscale)
    w[:, 0] = 0.0                     # an all-zero channel: the 1e-12 floor
    qw = quantize_weights(torch.from_numpy(w))
    ref = jax_quantize_weights(jnp.asarray(w))
    assert qw.q.dtype == torch.int8 and qw.scale.shape == (1, shape[1])
    np.testing.assert_array_equal(qw.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(qw.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(qw.zero_point.numpy(),
                                  np.asarray(ref.zero_point))
    np.testing.assert_array_equal(dequantize_weights(qw).numpy(),
                                  np.asarray(jax_dequantize_weights(ref)))
    assert qw.error_bound == ref.error_bound
    assert qw.nbytes == ref.nbytes
    got = quantization_error(torch.from_numpy(w))
    want = jax_quantization_error(jnp.asarray(w))
    # a mean sums in another order: 1e-6; the maxima are exact
    assert got.pop("mean_abs_err") == pytest.approx(
        want.pop("mean_abs_err"), rel=1e-6)
    assert got == want


@pytest.mark.parametrize("shape", [(2048, 75), (33, 70), (1, 129)])
def test_quantize_activations_is_bitwise_repro(shape):
    a = _np(1, *shape, scale=3.0)
    s = one_shot_act_scale(torch.from_numpy(a))
    assert s == jax_one_shot(jnp.asarray(a))
    for scale in (s, s * 0.5, 0.05):   # the last saturates most values
        np.testing.assert_array_equal(
            quantize_activations(torch.from_numpy(a), scale).numpy(),
            np.asarray(jax_quantize_acts(jnp.asarray(a), scale)))


def test_bf16_activations_quantize_as_repro():
    a = _np(2, 64, 48)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    s = one_shot_act_scale(ta)
    assert s == jax_one_shot(ja)
    np.testing.assert_array_equal(quantize_activations(ta, s).numpy(),
                                  np.asarray(jax_quantize_acts(ja, s)))


def test_calibrator_trajectory_is_repro_s():
    """The same amax sequence folds to the same floats, update by update,
    for observe() on tensors and observe_amax() on floats alike."""
    port, ref = ActCalibrator(), JaxActCalibrator()
    port2, ref2 = ActCalibrator(momentum=0.7), JaxActCalibrator(momentum=0.7)
    for i in range(8):
        a = _np(10 + i, 4, 32, scale=1 + i / 5)
        port.observe(torch.from_numpy(a), (32, 16))
        ref.observe(jnp.asarray(a), (32, 16))
        amax = float(np.abs(a).max()) * (i + 1)
        port2.observe_amax(amax, ("x",))
        ref2.observe_amax(amax, ("x",))
        assert port.scale_for((32, 16)) == ref.scale_for((32, 16))
        assert port2.state()[("x",)].amax == ref2.state()[("x",)].amax
    assert port.export_state() == ref.export_state()
    assert port2.export_state() == ref2.export_state()


def test_calibrator_export_import_round_trip():
    cal = ActCalibrator()
    for i in range(3):
        cal.observe_amax(1.0 + i / 3, (64, 64))
        cal.observe_amax(2.0 + i / 7, "fc")
    state = json.loads(json.dumps(cal.export_state()))
    restored = ActCalibrator()
    restored.import_state(state)
    assert restored.state() == cal.state()
    # repro reads the port's dump back to the same floats, and vice versa
    ref = JaxActCalibrator()
    ref.import_state(state)
    assert ref.export_state() == restored.export_state()
    # all three resume the SAME trajectory
    for c in (cal, restored, ref):
        c.observe_amax(5.0, (64, 64))
    assert (restored.scale_for((64, 64)) == cal.scale_for((64, 64))
            == ref.scale_for((64, 64)))


# ------------------------------- mirrors of tests/test_act_quant.py:39-76

def test_act_calibrator_ema_and_gating():
    cal = ActCalibrator(momentum=0.5, min_updates=2)
    assert cal.scale_for(("x",)) is None
    cal.observe(torch.full((4, 8), 2.0), ("x",))
    assert cal.scale_for(("x",)) is None          # still warming up
    cal.observe(torch.full((4, 8), 4.0), ("x",))
    assert cal.scale_for(("x",)) == pytest.approx(3.0 / 127.0)
    assert len(cal) == 1
    cal.reset()
    assert len(cal) == 0


def test_act_calibration_is_deterministic_across_runs():
    def run():
        cal = ActCalibrator()
        for i in range(5):
            cal.observe(torch.from_numpy(_np(20 + i, 4, 32)) * (1 + i / 5),
                        (32, 16))
        return cal.scale_for((32, 16))
    s1, s2 = run(), run()
    assert s1 == s2
    a, w = torch.from_numpy(_np(30, 8, 32)), torch.from_numpy(
        _np(31, 32, 16, scale=0.05))
    qw = quantize_weights(w)
    assert torch.equal(quant_gemm(a, qw, act_scale=s1),
                       quant_gemm(a, qw, act_scale=s2))


def test_quantize_activations_saturates():
    q = quantize_activations(torch.tensor([[-10.0, 0.0, 10.0]]), 0.05)
    assert q.dtype == torch.int8
    assert q.tolist() == [[-127, 0, 127]]


def test_quantize_roundtrip_error_bound():
    w = torch.from_numpy(_np(3, 96, 40, scale=0.2))
    qw = quantize_weights(w)
    assert isinstance(qw, QuantizedWeight)
    assert float(qw.zero_point.abs().max()) == 0.0          # symmetric
    err = (dequantize_weights(qw) - w).abs()
    assert bool((err <= qw.scale / 2 + 1e-7).all())
    assert float(err.max()) <= qw.error_bound + 1e-7


# ------------------------------------ mirrors of tests/test_quant_props.py

@settings(max_examples=8, deadline=None)
@given(k=st.integers(1, 96), n=st.integers(1, 96),
       wscale=st.floats(1e-3, 10.0), seed=st.integers(0, 2**16))
def test_quantize_error_within_calibrated_bound(k, n, wscale, seed):
    w = torch.from_numpy(_np(seed, k, n, scale=wscale))
    qw = quantize_weights(w)
    err = (dequantize_weights(qw) - w).abs()
    assert bool((err <= qw.scale / 2 + 1e-6 * wscale).all())
    assert float(err.max()) <= qw.error_bound + 1e-6 * wscale
    # and bitwise repro's
    np.testing.assert_array_equal(
        qw.q.numpy(), np.asarray(jax_quantize_weights(jnp.asarray(
            w.numpy())).q))


@settings(max_examples=5, deadline=None)
@given(m=st.integers(1, 48), k=st.integers(1, 48), n=st.integers(1, 48),
       seed=st.integers(0, 2**16))
def test_quant_gemm_error_tracks_weight_scale(m, k, n, seed):
    a = torch.from_numpy(_np(seed, m, k))
    w = torch.from_numpy(_np(seed + 1, k, n, scale=0.1))
    qw = quantize_weights(w)
    y_q = quant_gemm(a, qw)
    bound = a.abs().sum(dim=1, keepdim=True) * (qw.scale / 2)
    assert bool(((y_q - a @ w).abs() <= bound + 1e-5).all())


@settings(max_examples=5, deadline=None)
@given(m=st.integers(1, 32), k=st.integers(1, 64), n=st.integers(1, 64),
       wscale=st.floats(1e-3, 2.0), seed=st.integers(0, 2**16))
def test_int8x8_error_within_composed_scale_bound(m, k, n, wscale, seed):
    """|y_q - y_f| <= (s_a/2) sum_k|w_kj| + sum_k|a_ik| (s_wj/2)
    + k (s_a/2)(s_wj/2), per output element."""
    a = torch.from_numpy(_np(seed, m, k))
    w = torch.from_numpy(_np(seed + 1, k, n, scale=wscale))
    qw = quantize_weights(w)
    s_a = one_shot_act_scale(a)
    y_q = quant_gemm(a, qw, act_scale=s_a)
    y_f = a @ w
    half_sa, half_sw = s_a / 2.0, qw.scale / 2.0
    bound = (half_sa * w.abs().sum(dim=0, keepdim=True)
             + a.abs().sum(dim=1, keepdim=True) * half_sw
             + k * half_sa * half_sw)
    slack = 1e-5 * (1.0 + float(y_f.abs().max()))
    assert bool(((y_q - y_f).abs() <= bound + slack).all())


@settings(max_examples=5, deadline=None)
@given(batches=st.integers(1, 6), k=st.integers(1, 48),
       n=st.integers(1, 48), seed=st.integers(0, 2**16))
def test_seeded_act_calibration_deterministic_across_runs(batches, k, n,
                                                          seed):
    def calibrated_scale():
        cal = ActCalibrator()
        for i in range(batches):
            cal.observe(torch.from_numpy(_np(seed + i, 4, k)) * (1 + i),
                        (k, n))
        return cal.scale_for((k, n))

    s1, s2 = calibrated_scale(), calibrated_scale()
    assert s1 == s2 and s1 is not None
    a = torch.from_numpy(_np(seed + 99, 3, k))
    qw = quantize_weights(torch.from_numpy(_np(seed + 98, k, n, scale=0.1)))
    assert torch.equal(quantize_activations(a, s1),
                       quantize_activations(a, s2))
    assert torch.equal(quant_gemm(a, qw, act_scale=s1),
                       quant_gemm(a, qw, act_scale=s2))
