"""Build and bind the CUDA ``vpu_mm`` kernel (``csrc/vpu_mm.cu``).

The kernel replaces ``repro``'s Pallas ``vpu_mm_pallas``, the MXU-free
matmul.  It is built with ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (:mod:`repro_torch.kernels.common.build`).  Nothing here
runs at import time: the CPU tests import this module on machines with no
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["load_vpu_mm", "vpu_mm_library"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "vpu_mm.cu"


def vpu_mm_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("vpu_mm", _SOURCE)


def load_vpu_mm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("vpu_mm", _SOURCE)
