"""qmm — the int8 x int8 GEMM with an exact int32 accumulator (K2), the
quantized engine family's fixed-point compute path."""

from .ops import qmm_matmul
from .qmm import load_qmm, qmm_library
from .ref import qmm_ref

__all__ = ["qmm_matmul", "qmm_ref", "load_qmm", "qmm_library"]
