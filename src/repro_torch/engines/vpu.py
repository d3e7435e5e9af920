"""NeonVpuEngine — the card's analogue of the paper's NEON SIMD cores.

The paper keeps two NEON cores in the pool even though each is worth only
0.42 of an F-PE (§3.1.1): a slow-but-always-available engine raises
aggregate utilization because the thief protocol hands it tail work no
fast engine would miss.  ``repro`` models it on the TPU's VPU beside the
MXU; here it runs the hand-written ``vpu_mm`` kernel (CUDA-core FMAs as
rank-1 updates, no tensor cores) and presents a slow cost model to the
shared planners.

Calibration: the rate on the card is ``cuda-tiled``'s ranking rate times
``repro``'s VPU:MXU area ratio of 1/16, a ranking key and not a
measurement (the measured rate is in PERF.md).  On CPU tensors the
wrapper runs the kernel's plain version, at a rate that keeps
auto-dispatch away from it, exactly like ``cuda-tiled``.  The job tile
does not reach the kernel: its block tile is fixed and no blocking
changes its bits.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.device import device_type
from repro_torch.kernels.vpu_mm import ops as vpu_ops

from .base import (CAP_EPILOGUE, CAP_GEMM, CAP_INTERPRET, CAP_TILED,
                   CAP_VPU, CostModel, Engine)
from .builtin import CudaTiledEngine

__all__ = ["NeonVpuEngine"]

#: VPU:MXU area ratio of ``repro``'s calibration (8x128 lanes vs 128x128)
_VPU_MXU_RATIO = 1.0 / 16.0


class NeonVpuEngine(Engine):
    """The CUDA-core-only ``vpu_mm`` kernel as a registry engine."""

    def __init__(self, name: str = "neon-vpu", *,
                 cost: CostModel | None = None):
        """``cost`` overrides the device-derived model — benchmark pools
        inject paper-relative NEON rates to compare against sim PEs."""
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE, CAP_TILED,
                                CAP_INTERPRET, CAP_VPU}, cost=cost)

    def cost_on(self, device) -> CostModel:
        if self._cost is not None:       # steal-aware recalibration applied
            return self._cost
        if device_type(device) == "cuda":
            return CostModel(CudaTiledEngine._CUDA_RATE * _VPU_MXU_RATIO)
        return CostModel(1e6)   # plain version: auto-dispatch never picks it

    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        if b.dtype != a.dtype:
            b = b.to(a.dtype)
        return vpu_ops.vpu_matmul(a.contiguous(), b.contiguous(), bias=bias,
                                  activation=activation, out_dtype=out_dtype)
