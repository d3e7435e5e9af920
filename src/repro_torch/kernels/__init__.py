"""Hand-written Hopper kernels, one package per TPU kernel of ``repro``.

Each package holds the kernel's source (``csrc/``), the loader that builds
it at first use (``<name>.py``), the checked wrapper with its launch count
(``ops.py``) and the plain PyTorch version (``ref.py``)."""
