"""Build and bind the CUDA ``qmm`` kernel (``csrc/qmm.cu``).

The kernel replaces ``repro``'s Pallas ``qmm_pallas``, the int8 x int8
matmul with an exact int32 accumulator.  It is built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.common.build`).  Nothing here runs at import
time: the CPU tests import this module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["PATHS", "QMM_ARGTYPES", "load_qmm", "path_rule", "qmm_library",
           "qmm_path"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm.cu"

#: (a, w, scale, bias, c, m, n, k, out_dtype, act, stream) -> cudaError
QMM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: the kernel's paths, by the code ``qmm_path`` returns: 16-byte
#: ``cp.async`` copies (k and n multiples of 16, A and W on 16-byte
#: boundaries), or 4-byte copies realigned in shared memory by a funnel
#: shift, for any other shape or address
PATHS = ("async", "shift")


def qmm_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("qmm", _SOURCE)


def load_qmm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    lib = load_library("qmm", _SOURCE, QMM_ARGTYPES)
    lib.qmm_path.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int]
    lib.qmm_path.restype = ctypes.c_int
    return lib


def qmm_path(a_ptr: int, w_ptr: int, n: int, k: int) -> str:
    """The path the kernel takes for operands at these device addresses
    with this (n, k): the kernel's own choice, which m never enters and
    which reads the addresses modulo 16 only."""
    return _qmm_path(a_ptr % 16, w_ptr % 16, n, k)


@functools.lru_cache(maxsize=4096)
def _qmm_path(a_mod: int, w_mod: int, n: int, k: int) -> str:
    return PATHS[load_qmm().qmm_path(a_mod, w_mod, n, k)]


def path_rule(a_mod: int, w_mod: int, n: int, k: int) -> str:
    """``choose_path`` of ``csrc/qmm.cu`` in Python, for a GEMM traced on
    ``meta``, where no library is loaded: ``async`` when k and n are
    multiples of 16 and both operands start on 16-byte boundaries (their
    addresses modulo 16 are ``a_mod`` and ``w_mod``), else ``shift``.
    The card tests hold it to :func:`qmm_path`."""
    aligned = k % 16 == 0 and n % 16 == 0 and a_mod == 0 and w_mod == 0
    return PATHS[0] if aligned else PATHS[1]
