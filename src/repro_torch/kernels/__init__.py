"""Hand-written Hopper kernels, one package per TPU kernel of ``repro``,
and ``im2col``, the lowering of a CONV to a GEMM on the card.

Each package holds the kernel's source (``csrc/``), the loader that builds
it at first use (``<name>.py``), the checked wrapper with its launch count
(``ops.py``) and the plain PyTorch version (``ref.py``).  ``common/``
holds what the kernels share: the build, the checked launch and the
epilogue header."""
