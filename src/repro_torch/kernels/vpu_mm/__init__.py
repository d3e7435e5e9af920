"""vpu_mm — the MXU-free GEMM (K3), the NEON analogue: CUDA-core FMAs
only, bit-compatible with tiled_mm."""

from .ops import vpu_matmul
from .ref import vpu_mm_ref
from .vpu_mm import load_vpu_mm, vpu_mm_library

__all__ = ["vpu_matmul", "vpu_mm_ref", "load_vpu_mm", "vpu_mm_library"]
