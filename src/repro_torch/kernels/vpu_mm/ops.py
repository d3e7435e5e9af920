"""Checked wrapper of the CUDA ``vpu_mm`` kernel: the execution backend
of :class:`repro_torch.engines.NeonVpuEngine`.  Call sites dispatch
through ``synergy_matmul`` / the engine registry or a runtime's pool
rather than importing this directly.

A CPU tensor takes the plain version (:func:`vpu_mm_ref`); a CUDA tensor
launches the kernel or raises; a ``meta`` tensor is traced (the output's
stand-in, the call reported, nothing launched).
``vpu_matmul.launches`` counts kernel launches and nothing else, under
the lock that ``tiled_matmul.launches`` uses too."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.common.gemm import check_gemm, launch_gemm

from .ref import vpu_mm_ref
from .vpu_mm import load_vpu_mm

__all__ = ["vpu_matmul"]


def vpu_matmul(a: torch.Tensor, b: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               activation: Callable | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias) on the CUDA cores only (no tensor cores) for any
    (m, k) x (k, n), fp32 or bf16 inputs, fp32 accumulation, output in
    ``out_dtype`` (default: A's dtype).  The kernel chooses its tile by
    shape, which never changes a bit, and masks ragged edges, so no
    operand is padded; for fp32 its bits equal ``tiled_matmul``'s on the
    same operands."""
    check_gemm("vpu_matmul", a, b, bias, out_dtype)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return vpu_mm_ref(a, b, bias=bias, activation=activation,
                          out_dtype=out_dtype)
    return launch_gemm(vpu_matmul, lambda: load_vpu_mm().vpu_mm,
                       a, b, bias, activation, out_dtype, kernel="vpu_mm")


vpu_matmul.launches = 0
