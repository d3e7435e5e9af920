"""Roundings to the precision just below a configuration's, for the
controls that a cell's limits are set against: TF32 below float32 with
TF32 off.  Each maps a tensor to the nearest value of the lower
precision, kept in float32, so that a plain float32 product of rounded
operands is the product the lower precision's tensor cores would make."""

from __future__ import annotations

import torch

__all__ = ["round_tf32", "ROUNDINGS"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties to even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & -8192
    return i.view(torch.float32)


ROUNDINGS = {"tf32": round_tf32}
