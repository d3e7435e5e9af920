"""Build and bind the CUDA ``tiled_mm`` kernel (``csrc/tiled_mm.cu``).

The kernel replaces ``repro``'s Pallas ``tiled_mm_pallas``.  Its source is
compiled with ``nvcc`` for ``sm_90a`` at first use, into ``build/kernels/``
at the root of the checkout, under a name that hashes the source and the
flags, and bound with ``ctypes`` through its plain C entry point.  Nothing
here runs at import time: the CPU tests import this module on machines
with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_tiled_mm"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "tiled_mm.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "tiled_mm: nvcc not found (looked in $CUDA_HOME/bin and PATH); "
        "the CUDA kernel is built on the machine that runs it")


def _build() -> Path:
    """Compile the source unless a library for this exact source and these
    flags exists; the compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``.log``."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"tiled_mm-{digest[:16]}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first uses in
    # several processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp,
                               str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"tiled_mm: nvcc failed "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_tiled_mm() -> ctypes.CDLL:
    """The bound library, built on the first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            fn = lib.tiled_mm
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
