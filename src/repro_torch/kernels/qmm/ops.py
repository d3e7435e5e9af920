"""Checked wrapper of the CUDA ``qmm`` kernel: the execution backend of the
quantized engine family's int8 x int8 path (:mod:`repro_torch.quant`).
Call sites go through ``quant_gemm`` / ``QuantizedEngine`` / the runtime's
int32-partial split rather than importing this directly.

A CPU tensor takes the plain version (:func:`qmm_ref`); a CUDA tensor
launches the kernel or raises; a ``meta`` tensor is traced (the output's
stand-in, the call reported with the path the card would take,
:func:`~.qmm.path_rule`, nothing launched).  Integer accumulation is
exact, so the two agree bitwise on the raw int32 accumulator.
``qmm_matmul.launches`` counts kernel launches and nothing else, under
the lock the other kernels' counts use; ``qmm_matmul.launches_by_path``
splits them by the kernel's path (``async``, ``shift``:
:data:`~.qmm.PATHS`), which follows the operands' shape and alignment and
never changes a bit."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.common.gemm import (_ACT_CODES, _DTYPE_CODES,
                                             _INT_MAX, count_launch, nbytes,
                                             report_meta_call)

from .qmm import PATHS, load_qmm, path_rule, qmm_path
from .ref import qmm_ref

__all__ = ["qmm_matmul"]

_DT_I32 = 2     # the kernel's raw-accumulator output code


def _check(a_q, w_q, w_scale, bias, out_dtype, fuse_dequant) -> None:
    if a_q.dim() != 2 or w_q.dim() != 2 or a_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"qmm_matmul: need (m, k) @ (k, n), got "
                         f"{tuple(a_q.shape)} @ {tuple(w_q.shape)}")
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"qmm_matmul consumes int8 operands, got "
                        f"{a_q.dtype} x {w_q.dtype}")
    n = w_q.shape[1]
    if w_scale.numel() != n or not w_scale.is_floating_point():
        raise ValueError(f"qmm_matmul: w_scale must hold {n} floats, got "
                         f"{tuple(w_scale.shape)} {w_scale.dtype}")
    if bias is not None and (bias.numel() != n
                             or not bias.is_floating_point()):
        raise ValueError(f"qmm_matmul: bias must hold {n} floats, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if fuse_dequant and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"qmm_matmul: out_dtype {out_dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    devices = {t.device for t in (a_q, w_q, w_scale, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"qmm_matmul: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if not (a_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("qmm_matmul: A and W must be contiguous")
    if max(a_q.shape[0], a_q.shape[1], n) > _INT_MAX:
        raise ValueError("qmm_matmul: a dimension exceeds 2**31 - 1")


def qmm_matmul(a_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               *, act_scale: float = 1.0,
               bias: torch.Tensor | None = None,
               activation: Callable | None = None,
               out_dtype: torch.dtype = torch.float32,
               fuse_dequant: bool = True) -> torch.Tensor:
    """act((A_q @ W_q) * w_scale * act_scale + bias) for any int8 (m, k) x
    (k, n), with an exact int32 accumulator on the int8 tensor cores;
    ragged edges and unaligned rows are handled in the kernel, so nothing
    is padded or copied.  ``act_scale`` (a float: the online
    EMA publishes a fresh one per batch) is folded into the (1, n) scale
    operand in float32, which the kernel reads at run time, so no new
    scale rebuilds it.  ``fuse_dequant=False`` returns the raw int32
    accumulator."""
    _check(a_q, w_q, w_scale, bias, out_dtype, fuse_dequant)
    m, k = a_q.shape
    n = w_q.shape[1]
    scale = None
    if fuse_dequant:
        scale = (w_scale.reshape(n).to(torch.float32)
                 * float(act_scale)).contiguous()
    if a_q.device.type == "cpu":
        return qmm_ref(a_q, w_q, scale if fuse_dequant else w_scale,
                       bias=bias, activation=activation, out_dtype=out_dtype,
                       fuse_dequant=fuse_dequant)
    if a_q.device.type not in ("cuda", "meta"):
        raise ValueError(f"qmm_matmul: no kernel for device {a_q.device}")
    act = 0
    kernel_out = torch.int32
    if fuse_dequant:
        act = 0 if activation is None else _ACT_CODES.get(activation)
        # an activation the kernel does not fuse runs in torch on fp32
        kernel_out = out_dtype if act is not None else torch.float32
    out = torch.empty((m, n), dtype=kernel_out, device=a_q.device)
    if m == 0 or n == 0:
        return out if not fuse_dequant else out.to(out_dtype)
    if bias is not None and fuse_dequant:
        bias = bias.reshape(n).to(torch.float32).contiguous()
    else:
        bias = None
    if a_q.device.type == "meta":
        # no address: each operand's offset into its storage stands for it
        path = path_rule(a_q.storage_offset() % 16,
                         w_q.storage_offset() % 16, n, k)
        report_meta_call("qmm", 2.0 * m * n * k,
                         nbytes(a_q, w_q, scale, bias, out), path)
    else:
        entry = load_qmm().qmm
        with torch.cuda.device(a_q.device):
            stream = torch.cuda.current_stream(a_q.device).cuda_stream
            rc = entry(a_q.data_ptr(), w_q.data_ptr(),
                       None if scale is None else scale.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), m, n, k,
                       _DTYPE_CODES[kernel_out] if fuse_dequant else _DT_I32,
                       act or 0, stream)
        if rc != 0:
            raise RuntimeError(f"qmm_matmul: kernel launch failed with CUDA "
                               f"error {rc} for m={m} n={n} k={k}")
        count_launch(qmm_matmul,
                     qmm_path(a_q.data_ptr(), w_q.data_ptr(), n, k))
    if fuse_dequant and act is None:
        out = activation(out).to(out_dtype)
    return out


qmm_matmul.launches = 0
qmm_matmul.launches_by_path = dict.fromkeys(PATHS, 0)
