"""Build and bind the CUDA ``qmm`` kernel (``csrc/qmm.cu``).

The kernel replaces ``repro``'s Pallas ``qmm_pallas``, the int8 x int8
matmul with an exact int32 accumulator.  It is built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.common.build`).  Nothing here runs at import
time: the CPU tests import this module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["QMM_ARGTYPES", "load_qmm", "qmm_library"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm.cu"

#: (a, w, scale, bias, c, m, n, k, out_dtype, act, stream) -> cudaError
QMM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def qmm_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("qmm", _SOURCE)


def load_qmm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("qmm", _SOURCE, QMM_ARGTYPES)
