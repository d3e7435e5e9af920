"""Checked wrapper of the CUDA ``tiled_mm`` kernel: the execution backend
of :class:`repro_torch.engines.CudaTiledEngine`.  Call sites dispatch
through ``synergy_matmul`` / the engine registry rather than importing this
directly.

A CPU tensor takes the plain version (:func:`tiled_mm_ref`); a CUDA tensor
launches the kernel or raises; a ``meta`` tensor is traced: the output's
stand-in, the call reported with the path the card would take
(:func:`~.tiled_mm.path_rule`), nothing launched.
``tiled_matmul.launches`` counts kernel launches and nothing else, so a
run can show that it went through the kernel;
``tiled_matmul.launches_by_path`` splits them by the kernel's path
(``ffma``, ``mma``, ``wgmma``: :data:`~.tiled_mm.PATHS`)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.common.gemm import (_DTYPE_CODES, check_gemm,
                                             launch_gemm, misaligned)

from .ref import tiled_mm_ref
from .tiled_mm import PATHS, load_tiled_mm, path_rule, tiled_mm_path

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
    path = None
    if a.device.type in ("cuda", "meta"):
        choose = tiled_mm_path if a.device.type == "cuda" else path_rule
        path = choose(b.shape[1], a.shape[1], _DTYPE_CODES[a.dtype])
        if path == "wgmma":
            # TMA reads from 16-byte boundaries; a contiguous view that
            # starts elsewhere is copied (same values, same path)
            a, b = (t.clone() if misaligned(t) else t for t in (a, b))
    return launch_gemm(tiled_matmul, lambda: load_tiled_mm().tiled_mm,
                       a, b, bias, activation, out_dtype, path,
                       kernel="tiled_mm")


tiled_matmul.launches = 0
tiled_matmul.launches_by_path = dict.fromkeys(PATHS, 0)
