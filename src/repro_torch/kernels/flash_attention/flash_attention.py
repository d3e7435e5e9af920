"""Build and bind the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The kernel replaces ``repro``'s Pallas ``flash_attention_pallas``.  It is
built with ``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.common.build`).  Nothing here runs at import
time: the CPU tests import this module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.common.build import build_library, load_library

__all__ = ["FLASH_ATTENTION_ARGTYPES", "HEAD_DIMS", "flash_attention_library",
           "load_flash_attention"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: (q, k, v, o, b, hq, hkv, s, sk, d, scale, causal, dtype, stream)
#: -> cudaError
FLASH_ATTENTION_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]

#: the head dims the kernel is instantiated for: those of the zoo's ten
#: configs (64, 80 zamba2, 112 kimi, 128, 256 gemma), of their
#: ``reduced()`` versions (16) and of the training example's presets
#: (``examples_torch/train_lm.py``: 32 tiny, 48 small, 64 100m)
HEAD_DIMS = (16, 32, 48, 64, 80, 112, 128, 256)


def flash_attention_library() -> Path:
    """The built shared library (compiled on the first call)."""
    return build_library("flash_attention", _SOURCE)


def load_flash_attention() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    return load_library("flash_attention", _SOURCE,
                        FLASH_ATTENTION_ARGTYPES)
