"""Plain PyTorch version of the tiled_mm kernel: the oracle the CPU tests
use, the path a CPU tensor takes, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.qmm.ref import fma_f32

__all__ = ["ffma_chain_ref", "tiled_mm_ref"]


def tiled_mm_ref(a: torch.Tensor, b: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 activation: Callable | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(A @ B + bias) in fp32, cast to ``out_dtype`` (default: A's
    dtype).  The products are summed in float64 and rounded once to fp32,
    so a row's bits do not depend on how many rows share the call (a BLAS
    fp32 GEMM picks its algorithm by m): the plain version keeps the
    kernel's promise that a row panel gives the whole GEMM's rows, on
    which batched and per-slot serving decode agree bitwise."""
    y = torch.matmul(a.to(torch.float64),
                     b.to(torch.float64)).to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = activation(y)
    return y.to(out_dtype or a.dtype)


def ffma_chain_ref(a: torch.Tensor, b: torch.Tensor, *,
                   bias: torch.Tensor | None = None,
                   activation: Callable | None = None) -> torch.Tensor:
    """The fp32 bits of K1's ``ffma`` path (and of K3, which must equal
    them), emulated exactly on the CPU: every output starts from 0.0 and
    takes one ``fmaf`` per k in increasing k (:func:`fma_f32`), then
    act(acc + bias) in fp32, with a bias of 0.0 when there is none.  K1 and
    K3 share their mainloop's source, so holding one against the other
    cannot see a change of its order; this witness depends on no CUDA
    source.  ``activation`` is None or ``torch.relu`` (silu's ``expf`` is
    the device's own)."""
    if activation not in (None, torch.relu):
        raise ValueError("ffma_chain_ref: activation must be None or relu")
    a = a.detach().cpu().to(torch.float32)
    b = b.detach().cpu().to(torch.float32)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for kk in range(a.shape[1]):
        acc = fma_f32(a[:, kk:kk + 1], b[kk:kk + 1, :], acc)
    y = acc + (torch.zeros(b.shape[1]) if bias is None
               else bias.detach().cpu().to(torch.float32))
    return torch.relu(y) if activation is torch.relu else y
