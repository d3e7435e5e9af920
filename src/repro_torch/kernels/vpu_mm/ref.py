"""Plain PyTorch version of the vpu_mm kernel: the oracle the CPU tests
use, the path a CPU tensor takes, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card.

It computes the kernel's function, act(A @ B + bias) with an fp32 sum, as
one fp32 contraction; the kernel's sequential rank-1 order differs from it
only within fp32 rounding."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["vpu_mm_ref"]


def vpu_mm_ref(a: torch.Tensor, b: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               activation: Callable | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias), accumulated in fp32, cast to ``out_dtype``
    (default: A's dtype)."""
    y = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = activation(y)
    return y.to(out_dtype or a.dtype)
