"""Build and bind the CUDA ``ssd`` kernel (``csrc/ssd.cu``) and its frozen
witness (``csrc/ssd_witness.cu``).

The kernel replaces ``repro``'s Pallas ``ssd_pallas``, the Mamba2 SSD
chunked scan.  The witness is the kernel's first version, kept verbatim
(only its names changed and its shared helpers inlined) so that the card
tests can hold the redesigned kernel to its bits; nothing on a main path
calls it.  Both are built with ``nvcc`` for ``sm_90a`` at first use and
bound with ``ctypes`` (:mod:`repro_torch.kernels.common.build`).  Nothing
here runs at import time: the CPU tests import this module on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import load_library

__all__ = ["SSD_ARGTYPES", "SSD_HEAD_DIMS", "SSD_MAX_CHUNK", "SSD_SHAPES",
           "SSD_STATE_SIZES",
           "SSD_WITNESS_ARGTYPES", "load_ssd", "load_ssd_witness"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "ssd.cu"
_WITNESS = _CSRC / "ssd_witness.cu"

#: (xdt, dta, bm, cm, y, state, cb_workspace, b, h, l, p, n, chunk, dtype,
#: stream) -> cudaError
SSD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
#: the witness's entry point: the same without the workspace
SSD_WITNESS_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])

#: the head dims P the kernel is instantiated for: the zoo's SSM configs'
#: 64 and their ``reduced()`` versions' 16, whole or as one rank's share
#: when a mesh splits P over 'model' (2, 4 or 16 ranks)
SSD_HEAD_DIMS = (4, 8, 16, 32, 64)
#: the state sizes N: 64 (zamba2), 128 (mamba2-130m), 16 (reduced)
SSD_STATE_SIZES = (16, 64, 128)
#: every (P, N) pair the kernel takes
SSD_SHAPES = tuple((p, n) for p in SSD_HEAD_DIMS for n in SSD_STATE_SIZES)
SSD_MAX_CHUNK = 128


def load_ssd() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("ssd", _SOURCE, SSD_ARGTYPES)


def load_ssd_witness() -> ctypes.CDLL:
    """The witness's bound library, built on the first call in this
    process."""
    return load_library("ssd_witness", _WITNESS, SSD_WITNESS_ARGTYPES)
