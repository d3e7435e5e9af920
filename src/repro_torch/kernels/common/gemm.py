"""The checked launch that the port's GEMM wrappers share.

``tiled_matmul`` (K1) and ``vpu_matmul`` (K3) take the same operands and
export the same C entry point, so they share the argument check, the
launch on the caller's current stream, the error check after it, and the
launch count.  The count is a plain integer attribute on the wrapper
function, raised under one process-wide lock: the runtime's worker
threads launch both kernels at once, and an unlocked ``+= 1`` would lose
increments.  A wrapper whose kernel has several paths (``tiled_matmul``)
also keeps ``launches_by_path``, a dict of counts raised under the same
lock.

On ``meta`` operands a wrapper launches nothing: it makes the kernel's
outputs (and workspaces) as ``meta`` tensors of the kernel's shapes and
dtypes, and reports the call, with its plain formulation's flops and the
bytes it reads and writes, to a traced step that listens
(:func:`report_meta_call`); ``launches`` does not move."""

from __future__ import annotations

import threading
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["check_gemm", "launch_gemm", "count_launch", "report_meta_call",
           "nbytes", "misaligned"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: activations fused into the kernels' epilogue (code 0 is no activation);
#: any other callable runs in torch after an unfused GEMM
_ACT_CODES: dict[Callable, int] = {torch.relu: 1, F.relu: 1, F.silu: 2}
_INT_MAX = 2**31 - 1

_launch_lock = threading.Lock()


def count_launch(wrapper, path: str | None = None) -> None:
    """``wrapper.launches += 1`` and, given the kernel path that ran,
    ``wrapper.launches_by_path[path] += 1``, atomically."""
    with _launch_lock:
        wrapper.launches += 1
        if path is not None:
            wrapper.launches_by_path[path] += 1


def report_meta_call(kernel: str, flops: float, nbytes: float,
                     path: str | None = None) -> None:
    """Report one call of ``kernel`` on ``meta`` operands (``flops``, the
    plain formulation's; ``nbytes``, each input read once and each output
    written once; ``path``, the kernel path the card would take) to every
    active dispatch mode that records such calls: a step traced by
    :func:`repro_torch.launch.hlo_analysis.analyze_step`.  Autograd carries
    the mode stack into the backward, so a recomputation there reports
    too."""
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "kernel_call", None)
        if record is not None:
            record(kernel, flops, nbytes, path)


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def misaligned(t: torch.Tensor) -> bool:
    """Whether ``t`` starts off a 16-byte boundary.  A ``meta`` tensor has
    no address; its offset into its storage stands for it (the card's
    allocations start on 512-byte boundaries)."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size() % 16 != 0
    return t.data_ptr() % 16 != 0


def check_gemm(name: str, a, b, bias, out_dtype) -> None:
    """Raise on what the kernels do not take."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: need (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"{name}: A and B must share a dtype in "
                        f"{list(_DTYPE_CODES)}, got {a.dtype}, {b.dtype}")
    if out_dtype is not None and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != b.shape[1]
                             or not bias.is_floating_point()):
        raise ValueError(f"{name}: bias must be a float vector of length "
                         f"{b.shape[1]}, got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    devices = {t.device for t in (a, b, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: A and B must be contiguous")
    if max(a.shape[0], a.shape[1], b.shape[1]) > _INT_MAX:
        raise ValueError(f"{name}: a dimension exceeds 2**31 - 1")


def launch_gemm(wrapper, load: Callable, a: torch.Tensor, b: torch.Tensor,
                bias: torch.Tensor | None, activation: Callable | None,
                out_dtype: torch.dtype, path: str | None = None, *,
                kernel: str) -> torch.Tensor:
    """act(A @ B + bias) by the kernel that ``load()`` binds, launched on
    the current stream of A's card; counts the launch on ``wrapper`` (and
    under ``path``, the kernel path it takes, when given).  On ``meta``
    operands nothing is launched: the call is reported as ``kernel``
    (:func:`report_meta_call`).  The operands have passed
    :func:`check_gemm`."""
    name = wrapper.__name__
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {a.device}")
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
    if a.device.type == "meta":
        report_meta_call(kernel, 2.0 * m * n * k, nbytes(a, b, bias, out),
                         path)
    else:
        entry = load()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = entry(a.data_ptr(), b.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), m, n, k, _DTYPE_CODES[a.dtype],
                       _DTYPE_CODES[kernel_out], act or 0, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {rc} for m={m} n={n} k={k}")
        count_launch(wrapper, path)
    if act is None:
        out = activation(out).to(out_dtype)
    return out
