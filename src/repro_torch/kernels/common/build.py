"""Build and bind a kernel source of the port with ``nvcc``.

Each source is compiled for ``sm_90a`` at first use, into
``build/kernels/`` at the root of the checkout, under a name that hashes
the source, the headers beside it, the shared headers of this directory
and the flags, and bound with ``ctypes`` through its plain C entry point.
Nothing here runs at import time: the CPU tests import this module on
machines with no CUDA toolkit.  Builds of different sources may run at
once (one lock per source), so a caller can start every ``nvcc``
together.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["GEMM_ARGTYPES", "build_library", "cuda_tool", "load_library",
           "sass_opcodes"]

_COMMON = Path(__file__).resolve().parent
_BUILD_DIR = _COMMON.parents[3] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               f"-I{_COMMON}")

#: the C entry point every GEMM kernel exports:
#: (a, b, bias, c, m, n, k, in_dtype, out_dtype, act, stream) -> cudaError
GEMM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", name), shutil.which(name)):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"{name} not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
        f"kernels are built on the machine that runs them")


def build_library(name: str, source: Path) -> Path:
    """Compile ``source`` unless a library for this exact source, the
    headers beside it and here, and these flags exists; the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted([*_COMMON.glob("*.cuh"),
                          *source.parent.glob("*.cuh")]):
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS[:-1]).encode())
    so = _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = cuda_tool("nvcc")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first uses in
    # several processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library(name: str, source: Path,
                 argtypes: list = GEMM_ARGTYPES) -> ctypes.CDLL:
    """The bound library of a kernel, built on the first call in this
    process; its entry point ``name`` gets ``argtypes`` (the GEMM entry
    point's by default) and returns the CUDA error as an int.  Once bound,
    a call takes no lock: every launch goes through here."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name, source)))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


#: one SASS instruction line of ``cuobjdump -sass``:
#: ``/*0070*/  @!P0 FFMA R1, R2, R3, R4 ;  /* 0x... */``
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*)")


def sass_opcodes(library: Path) -> collections.Counter:
    """How often each opcode (without its ``.`` modifiers) occurs in the
    SASS of a built library: what the card really runs."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return collections.Counter(_SASS_LINE.findall(sass))
