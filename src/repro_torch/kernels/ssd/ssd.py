"""Build and bind the CUDA ``ssd`` kernel (``csrc/ssd.cu``).

The kernel replaces ``repro``'s Pallas ``ssd_pallas``, the Mamba2 SSD
chunked scan.  It is built with ``nvcc`` for ``sm_90a`` at first use and
bound with ``ctypes`` (:mod:`repro_torch.kernels.common.build`).  Nothing
here runs at import time: the CPU tests import this module on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import load_library

__all__ = ["SSD_ARGTYPES", "SSD_SHAPES", "SSD_MAX_CHUNK", "load_ssd"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"

#: (xdt, dta, bm, cm, y, state, b, h, l, p, n, chunk, dtype, stream)
#: -> cudaError
SSD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

#: the (head dim P, state size N) pairs the kernel is instantiated for:
#: the zoo's SSM configs (P 64; N 64 zamba2, 128 mamba2-130m) and their
#: ``reduced()`` versions (P 16, N 16)
SSD_SHAPES = ((64, 64), (64, 128), (16, 16))
SSD_MAX_CHUNK = 128


def load_ssd() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("ssd", _SOURCE, SSD_ARGTYPES)
