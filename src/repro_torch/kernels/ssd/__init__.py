"""ssd — the Mamba2 state-space-duality chunked scan (K5), the sequence
mixer of the zoo's SSM and hybrid prefill."""

from .ops import SSDFunction, ssd, ssd_chunked, ssd_cuda
from .ref import ssd_ref
from .ssd import load_ssd

__all__ = ["SSDFunction", "ssd", "ssd_chunked", "ssd_cuda", "ssd_ref",
           "load_ssd"]
