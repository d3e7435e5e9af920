"""Symmetric per-channel int8 weight quantization — the numeric core of the
quantized engine family (``repro.quant.quantize``, ported).

Weights of a GEMM ``A[m, k] @ W[k, n]`` quantize along the contraction
axis with one fp32 scale per output channel; the dequant multiplier is
applied as an epilogue after the int8 weights are read.  Symmetric means
the zero point is identically 0; the container still carries it.

Rounding on the card: a float32 CUDA tensor divided by a Python float is
computed as a multiply by the reciprocal, which can be one ulp off the
true quotient.  Every division here divides by a tensor on the operands'
device, which is a true division on the CPU and on the card alike, so
the card quantizes bitwise as the CPU (and as ``repro``) does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["QuantizedWeight", "quantize_weights", "dequantize_weights",
           "dequant_epilogue", "dequant_finish", "quant_gemm",
           "quantization_error"]

#: int8 symmetric range: round-to-nearest lands within scale/2 per element
_QMAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """One quantized GEMM weight: ``w ~= (q - zero_point) * scale``.

    ``q``          int8, same shape as the source weight (k, n).
    ``scale``      fp32 (1, n) — one scale per output channel.
    ``zero_point`` int32 (1, n) — identically 0 for the symmetric scheme.
    """

    q: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.q, self.scale, self.zero_point))

    @property
    def error_bound(self) -> float:
        """Per-element worst-case reconstruction error: round-to-nearest
        symmetric int8 is off by at most scale/2."""
        return float(self.scale.max()) / 2.0


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded as a true float32 division on any device
    (the divisor becomes a 0-dim tensor on x's device, not a scalar)."""
    return x / torch.full((), divisor, dtype=torch.float32, device=x.device)


def quantize_weights(w: torch.Tensor) -> QuantizedWeight:
    """w (k, n) -> symmetric per-output-channel int8 (quantize along k)."""
    w32 = w.to(torch.float32)
    scale = _true_div(w32.abs().amax(dim=-2, keepdim=True), _QMAX)
    scale = scale.clamp_min(1e-12)
    q = torch.round(w32 / scale).clamp(-_QMAX, _QMAX).to(torch.int8)
    zp = torch.zeros_like(scale, dtype=torch.int32)
    return QuantizedWeight(q=q, scale=scale, zero_point=zp)


def dequantize_weights(qw: QuantizedWeight,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return ((qw.q.to(torch.float32) - qw.zero_point.to(torch.float32))
            * qw.scale).to(dtype)


def dequant_epilogue(acc: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Fold the per-channel scale into an fp32 GEMM accumulator:
    ``(a @ q) * scale == a @ (q * scale)`` because the scale is constant
    along the contraction axis."""
    return acc * qw.scale.reshape(1, -1).to(torch.float32)


def dequant_finish(acc: torch.Tensor, qw: QuantizedWeight, *,
                   act_scale: float | None = None,
                   bias: torch.Tensor | None = None,
                   activation: Callable | None = None,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The ONE epilogue tail the unfused quantized paths share (the
    weight-only ``quant_gemm``, ``QuantizedEngine.execute_weight_only`` and
    the runtime's int32-partial merge): dequant scale -> activation scale
    -> bias -> activation -> final cast, each a separate fp32 op, rounded
    one at a time.  (The qmm kernel's fused epilogue rounds the scale and
    bias once, so the two differ in the last bit; neither is the other.)

    ``acc`` is either an fp32 accumulator of the weight-only path
    (``act_scale`` None) or the raw int32 accumulator of the int8×int8
    path, whose per-tensor activation scale composes multiplicatively
    with the per-channel weight scale."""
    y = dequant_epilogue(acc.to(torch.float32), qw)
    if act_scale is not None:
        y = y * float(act_scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = activation(y)
    return y.to(out_dtype)


def quant_gemm(a: torch.Tensor, qw: QuantizedWeight, *,
               act_scale: float | None = None,
               bias: torch.Tensor | None = None,
               activation: Callable | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ dequant(q) + bias) over int8 weights, two compute paths:

    ``act_scale`` given (the calibrated per-tensor activation scale) —
    the TRUE int8×int8 path: quantize A at that scale and run the qmm
    kernel, whose contraction consumes int8 operands with exact int32
    accumulation; scale -> bias -> activation fuse into the epilogue.

    ``act_scale`` None — the weight-only fallback: int8 weights enter a
    floating product at fp32 (1 byte/elem weight read), then the shared
    dequant tail."""
    out_dtype = out_dtype or a.dtype
    if act_scale is not None:
        from repro_torch.kernels.qmm import qmm_matmul

        from .act import quantize_activations
        a_q = quantize_activations(a, act_scale)
        lead = a_q.shape[:-1]
        y = qmm_matmul(a_q.reshape(-1, a_q.shape[-1]), qw.q, qw.scale,
                       act_scale=act_scale, bias=bias,
                       activation=activation, out_dtype=out_dtype)
        return y.reshape(*lead, y.shape[-1])
    acc = torch.matmul(a.to(torch.float32), qw.q.to(torch.float32))
    return dequant_finish(acc, qw, bias=bias, activation=activation,
                          out_dtype=out_dtype)


def quantization_error(w: torch.Tensor,
                       qw: QuantizedWeight | None = None) -> dict:
    """Reconstruction-error metrics of one weight (the calibration module
    aggregates these per GEMM shape)."""
    if qw is None:
        qw = quantize_weights(w)
    deq = dequantize_weights(qw, dtype=torch.float32)
    err = (deq - w.to(torch.float32)).abs()
    denom = float(w.abs().max()) + 1e-12
    return {
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max()) / denom,
        "mean_abs_err": float(err.mean()),
        "error_bound": qw.error_bound,
    }
