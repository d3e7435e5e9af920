"""Build and bind the CUDA ``tiled_mm`` kernel (``csrc/tiled_mm.cu``).

The kernel replaces ``repro``'s Pallas ``tiled_mm_pallas``.  It is built
with ``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.common.build`).  Nothing here runs at import
time: the CPU tests import this module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["PATHS", "load_tiled_mm", "path_rule", "tiled_mm_library",
           "tiled_mm_path"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "tiled_mm.cu"

#: the kernel's paths, by the code ``tiled_mm_path`` returns: fp32 FFMA,
#: bf16 ``mma.sync`` (shapes TMA cannot read), bf16 ``wgmma`` + TMA
PATHS = ("ffma", "mma", "wgmma")


def tiled_mm_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("tiled_mm", _SOURCE)


def load_tiled_mm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    lib = load_library("tiled_mm", _SOURCE)
    lib.tiled_mm_path.argtypes = [ctypes.c_int] * 3
    lib.tiled_mm_path.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def tiled_mm_path(n: int, k: int, dtype_code: int) -> str:
    """The path the kernel takes for a GEMM of this (n, k, input dtype
    code): the kernel's own choice, which m never enters (asked once per
    distinct GEMM)."""
    return PATHS[load_tiled_mm().tiled_mm_path(n, k, dtype_code)]


def path_rule(n: int, k: int, dtype_code: int) -> str:
    """``choose_path`` of ``csrc/tiled_mm.cu`` in Python, for a GEMM traced
    on ``meta``, where no library is loaded: fp32 ``ffma``; bf16 ``wgmma``
    when k and n are multiples of 8, else ``mma``.  The card tests hold it
    to :func:`tiled_mm_path`."""
    if dtype_code == 0:
        return "ffma"
    return "wgmma" if k > 0 and k % 8 == 0 and n % 8 == 0 else "mma"
