"""Checked wrapper of the CUDA ``tiled_mm`` kernel: the execution backend
of :class:`repro_torch.engines.CudaTiledEngine`.  Call sites dispatch
through ``synergy_matmul`` / the engine registry rather than importing this
directly.

A CPU tensor takes the plain version (:func:`tiled_mm_ref`); a CUDA tensor
launches the kernel or raises.  ``tiled_matmul.launches`` counts kernel
launches and nothing else, so a run can show that it went through the
kernel."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.common.gemm import check_gemm, launch_gemm

from .ref import tiled_mm_ref
from .tiled_mm import load_tiled_mm

__all__ = ["tiled_matmul"]


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 activation: Callable | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias) for any (m, k) x (k, n), fp32 or bf16 inputs,
    fp32 accumulation, output in ``out_dtype`` (default: A's dtype).
    Ragged edges are masked inside the kernel, so no operand is padded."""
    check_gemm("tiled_matmul", a, b, bias, out_dtype)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tiled_mm_ref(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)
    return launch_gemm(tiled_matmul, lambda: load_tiled_mm().tiled_mm,
                       a, b, bias, activation, out_dtype)


tiled_matmul.launches = 0
