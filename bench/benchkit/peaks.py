"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no
sparsity; at its 700 W limit).  A card set below 700 W reaches less: each
result line carries the card's power limit beside its shares."""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "roofline_s"]

#: operations per second by the dtype the operands are multiplied in
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12, "float8": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the memory's bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
