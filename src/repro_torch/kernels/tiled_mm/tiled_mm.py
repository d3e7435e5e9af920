"""Build and bind the CUDA ``tiled_mm`` kernel (``csrc/tiled_mm.cu``).

The kernel replaces ``repro``'s Pallas ``tiled_mm_pallas``.  It is built
with ``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.common.build`).  Nothing here runs at import
time: the CPU tests import this module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import load_library

__all__ = ["load_tiled_mm"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "tiled_mm.cu"


def load_tiled_mm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("tiled_mm", _SOURCE)
