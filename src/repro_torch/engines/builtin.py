"""Built-in GEMM engines: ``torch.matmul``, the CUDA tile kernel, the plain
fp32 oracle.

Counterparts of ``repro``'s ``XlaEngine``, ``PallasTiledEngine`` and
``ReferenceEngine`` (see :data:`repro_torch.engines.ENGINE_NAME_MAP`).
Rates are deliberately coarse — they only need to order the engines per
device of the GEMM's operands: on CUDA tensors the hand-written tile
kernel (the Synergy PE) ranks first, on CPU tensors ``torch.matmul`` does
(the tile engine would only run its plain version there), and the oracle
never wins.  They are ranking keys, not measurements.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.tiled_mm import ops as tiled_ops
from repro_torch.kernels.tiled_mm.ref import tiled_mm_ref

from .base import (CAP_EPILOGUE, CAP_GEMM, CAP_GRAD, CAP_INTERPRET,
                   CAP_ORACLE, CAP_TILED, CostModel, Engine)

__all__ = ["TorchEngine", "CudaTiledEngine", "ReferenceEngine"]


def _device_type(device) -> str:
    """``device``'s type; None means the port's default device, the card
    when there is one."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


class TorchEngine(Engine):
    """``torch.matmul`` in fp32 with the epilogue in torch — the CPU path
    and the grad-safe engine (autograd runs through it).  Handles storage
    dtype != compute dtype: B is cast to A's dtype on read."""

    #: coarse sustained MAC rates used only to RANK engines per device
    _RATES = {"cuda": 30e12, "cpu": 2e9}

    def __init__(self, name: str = "torch"):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE, CAP_GRAD})

    def cost_on(self, device) -> CostModel:
        if self._cost is not None:       # steal-aware recalibration applied
            return self._cost
        return CostModel(self._RATES.get(_device_type(device), 2e9))

    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        if b.dtype != a.dtype:
            b = b.to(a.dtype)
        y = torch.matmul(a.to(torch.float32), b.to(torch.float32))
        if bias is not None:
            y = y + bias.to(torch.float32)
        if activation is not None:
            y = activation(y)
        return y.to(out_dtype or a.dtype)


class CudaTiledEngine(Engine):
    """The hand-written CUDA ``tiled_mm`` kernel — the Synergy PE on the
    card (fixed block tile, fused epilogue).  On CPU tensors its wrapper
    runs the kernel's plain version, so pinning it there is a validation
    path; auto-dispatch picks it only for CUDA tensors.  ``tile`` sizes
    the JobSet accounting and does not change the result."""

    _CUDA_RATE = 60e12

    def __init__(self, name: str = "cuda-tiled"):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE, CAP_TILED,
                                CAP_INTERPRET})

    def cost_on(self, device) -> CostModel:
        if self._cost is not None:       # steal-aware recalibration applied
            return self._cost
        if _device_type(device) == "cuda":
            return CostModel(self._CUDA_RATE)
        return CostModel(2e6)   # plain version: auto-dispatch never picks it

    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        if b.dtype != a.dtype:
            b = b.to(a.dtype)
        return tiled_ops.tiled_matmul(a.contiguous(), b.contiguous(),
                                      bias=bias, activation=activation,
                                      out_dtype=out_dtype)


class ReferenceEngine(Engine):
    """Plain fp32 oracle — correctness baseline, never speed-ranked."""

    def __init__(self, name: str = "reference"):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE, CAP_GRAD, CAP_ORACLE},
                         cost=CostModel(5e7))

    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        return tiled_mm_ref(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)
