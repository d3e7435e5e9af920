"""Plain PyTorch version of the vpu_mm kernel: the oracle the CPU tests
use, the path a CPU tensor takes, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card.

It computes the kernel's function, act(A @ B + bias), with the products
summed in float64 and rounded once to fp32, as ``tiled_mm_ref`` does: a
row's bits do not depend on how many rows share the call, and the
kernel's sequential rank-1 fp32 order differs from it only within fp32
rounding."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["vpu_mm_ref"]


def vpu_mm_ref(a: torch.Tensor, b: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               activation: Callable | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias) in fp32 (a float64 sum rounded once), cast to
    ``out_dtype`` (default: A's dtype)."""
    y = torch.matmul(a.to(torch.float64),
                     b.to(torch.float64)).to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = activation(y)
    return y.to(out_dtype or a.dtype)
