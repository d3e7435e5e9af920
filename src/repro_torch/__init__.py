"""repro_torch — the PyTorch/CUDA port of ``repro``, the Synergy
reproduction, for NVIDIA Hopper.

It mirrors ``repro``'s layout (``core/``, ``engines/``, ``kernels/``,
``models/``, ``configs/``, ``obs/``) and public names, imports ``torch``
and never JAX, and runs its kernels on the card.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""
