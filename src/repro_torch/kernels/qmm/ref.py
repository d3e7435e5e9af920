"""Plain PyTorch version of the qmm kernel: the oracle the CPU tests use,
the path a CPU tensor takes, and what ``chip_smoke.py`` holds the CUDA
kernel against on the card.

Integer accumulation is exact, so the raw int32 accumulator is bitwise the
kernel's.  The sum runs in float64, exact here (|acc| <= k * 128 * 128 is
far below 2**53), because PyTorch has no integer matrix product on the
card.  The fused epilogue with a bias is ONE rounding, as the kernel's
``fmaf`` and ``repro``'s XLA-contracted epilogue are: the exact product
plus the bias is formed in float64, rounded to odd, then to float32.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["qmm_ref", "fma_f32"]


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``fmaf(x, y, z)`` elementwise on float32 tensors: x * y + z rounded
    once.  The product of two float32 values is exact in float64; the sum
    is rounded to float64 by round-to-odd (exact sum from TwoSum, then the
    last bit forced odd when the sum was inexact), and the rounding to
    float32 is then the correctly rounded one (53 >= 24 + 2 bits)."""
    p = x.double() * y.double()
    b = z.double().expand_as(p)
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def qmm_ref(a_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
            act_scale: float = 1.0,
            bias: torch.Tensor | None = None,
            activation: Callable | None = None,
            out_dtype: torch.dtype = torch.float32,
            fuse_dequant: bool = True) -> torch.Tensor:
    """act((A_q @ W_q) * scale * act_scale + bias) for int8 operands with
    an exact int32 accumulator.  ``scale`` is the (1, n) dequant multiplier
    (callers usually fold the activation scale in, in float32, and leave
    ``act_scale`` at 1).  ``fuse_dequant=False`` returns the raw int32
    accumulator (the runtime's panel mode)."""
    acc = torch.matmul(a_q.double(), w_q.double()).to(torch.int32)
    if not fuse_dequant:
        return acc
    s = scale.reshape(1, -1).float() * float(act_scale)
    x = acc.float()
    if bias is None:
        y = x * s
    else:
        y = fma_f32(x, s, bias.reshape(1, -1).float())
    if activation is not None:
        y = activation(y)
    return y.to(out_dtype)
