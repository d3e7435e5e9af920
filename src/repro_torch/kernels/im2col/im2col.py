"""Build and bind the CUDA ``im2col`` kernel (``csrc/im2col.cu``).

The kernel replaces no Pallas kernel: ``repro``'s im2col is a ``jnp``
gather.  On the card it writes the patch matrix once from NHWC ``x``, in
place of the plain version's pad, index uploads, two gathers and copy.
It is built with ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes`` (:mod:`repro_torch.kernels.common.build`).  Nothing here runs
at import time: the CPU tests import this module on machines with no CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["ACCESS_WIDTHS", "IM2COL_ARGTYPES", "access_rule",
           "im2col_library", "load_im2col"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "im2col.cu"

#: (x, out, n, h, w, c, kh, kw, stride, pad, oh, ow, elem_size, stream)
#: -> cudaError
IM2COL_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])

#: the bytes a thread moves at once, widest first
ACCESS_WIDTHS = (16, 8, 4, 2, 1)


def im2col_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("im2col", _SOURCE)


def load_im2col() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    lib = load_library("im2col", _SOURCE, IM2COL_ARGTYPES)
    lib.im2col_vec.argtypes = [ctypes.c_int] * 3
    lib.im2col_vec.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def access_rule(c: int, k: int, elem_size: int) -> int:
    """``vec_bytes`` of ``csrc/im2col.cu`` in Python: the widest of
    :data:`ACCESS_WIDTHS` that divides both ``c`` and ``k`` times
    ``elem_size``, so that a vector never crosses an (i, j) segment of a
    row and every row starts on its boundary.  The card tests hold it to
    the kernel's own ``im2col_vec``."""
    return next(v for v in ACCESS_WIDTHS
                if c * elem_size % v == 0 and k * elem_size % v == 0)
