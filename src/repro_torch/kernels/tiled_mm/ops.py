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
import torch.nn.functional as F

from .ref import tiled_mm_ref
from .tiled_mm import load_tiled_mm

__all__ = ["tiled_matmul"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: activations fused into the kernel's epilogue (code 0 is no activation);
#: any other callable runs in torch after an unfused GEMM
_ACT_CODES: dict[Callable, int] = {torch.relu: 1, F.relu: 1, F.silu: 2}
_INT_MAX = 2**31 - 1


def _check(a, b, bias, out_dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: need (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"tiled_matmul: A and B must share a dtype in "
                        f"{list(_DTYPE_CODES)}, got {a.dtype}, {b.dtype}")
    if out_dtype is not None and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"tiled_matmul: out_dtype {out_dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != b.shape[1]
                             or not bias.is_floating_point()):
        raise ValueError(f"tiled_matmul: bias must be a float vector of "
                         f"length {b.shape[1]}, got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    devices = {t.device for t in (a, b, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tiled_matmul: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul: A and B must be contiguous")
    if max(a.shape[0], a.shape[1], b.shape[1]) > _INT_MAX:
        raise ValueError("tiled_matmul: a dimension exceeds 2**31 - 1")


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 activation: Callable | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias) for any (m, k) x (k, n), fp32 or bf16 inputs,
    fp32 accumulation, output in ``out_dtype`` (default: A's dtype).
    Ragged edges are masked inside the kernel, so no operand is padded."""
    _check(a, b, bias, out_dtype)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tiled_mm_ref(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: no kernel for device {a.device}")
    lib = load_tiled_mm()
    m, k = a.shape
    n = b.shape[1]
    act = 0 if activation is None else _ACT_CODES.get(activation)
    # an activation the kernel does not fuse runs in torch on the fp32 sum
    kernel_out = out_dtype if act is not None else torch.float32
    out = torch.empty((m, n), dtype=kernel_out, device=a.device)
    if m == 0 or n == 0:
        return out.to(out_dtype)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tiled_mm(a.data_ptr(), b.data_ptr(),
                          None if bias is None else bias.data_ptr(),
                          out.data_ptr(), m, n, k, _DTYPE_CODES[a.dtype],
                          _DTYPE_CODES[kernel_out], act or 0, stream)
    if rc != 0:
        raise RuntimeError(f"tiled_matmul: kernel launch failed with CUDA "
                           f"error {rc} for m={m} n={n} k={k}")
    tiled_matmul.launches += 1
    if act is None:
        out = activation(out).to(out_dtype)
    return out


tiled_matmul.launches = 0
