"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["resolve_device", "device_type", "ranked_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device``, defaulting to the card; raises when the card is asked
    for and there is none (nothing falls back to the CPU quietly).  A card
    named without an index is the current one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_type(device) -> str:
    """``device``'s type; None means the port's default device, the card
    when there is one."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def ranked_device(device) -> torch.device:
    """The device whose engines rank a GEMM with operands on ``device``:
    that device, except ``meta`` inside a traced step
    (:func:`repro_torch.launch.hlo_analysis.analyze_step`), whose GEMMs
    rank as on the device the step will run on, so that the trace takes
    the card's kernels.  No decision on a CPU or CUDA tensor changes."""
    dev = torch.device(device)
    if dev.type == "meta":
        for mode in _get_current_dispatch_mode_stack():
            target = getattr(mode, "stands_for", None)
            if target is not None:
                return torch.device(target)
    return dev
