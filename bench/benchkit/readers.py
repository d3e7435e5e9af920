"""What a per-layer metric's reader (``bench/metrics/<name>.py``) gets,
and the arithmetic the readers share.

A reader is ``read(reading) -> float | None``: None when the trace holds
nothing for it to read, and the harness then leaves the metric out.  A
share of a roofline or of a peak is never returned as 0 in place of
nothing.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

from .peaks import PEAK_FLOPS

__all__ = ["Reading", "UNATTRIBUTED_MAX", "mfu_pct", "idle_pct",
           "device_s_per_batch", "roofline_pct"]

#: above this share of the layer window's device time without a launch
#: in the trace, no device time is attributed to a layer
UNATTRIBUTED_MAX = 0.02


@dataclasses.dataclass
class Reading:
    """The traced windows of one run, reduced."""

    config: dict
    traffic: dict
    driver: ModuleType          # the cell's driver (its counts of work)
    window_s: float             # the device window
    busy_s: float
    batches: int                # batches completed in the device window
    layer_batches: int          # batches completed in the layer window
    by_stack: dict              # device seconds by launching stack


def mfu_pct(r: Reading, dtype: str) -> float | None:
    """The model's operations in the device window over the window's
    length, as a share of the card's peak for ``dtype``."""
    if r.window_s <= 0 or r.batches <= 0:
        return None
    flops = r.driver.model_flops(r.config, r.traffic) * r.batches
    return 100.0 * flops / r.window_s / PEAK_FLOPS[dtype]


def idle_pct(r: Reading) -> float | None:
    """The share of the device window in which nothing ran on the card."""
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def _matches(stack: tuple, patterns: tuple) -> bool:
    return any(frame.startswith(p) for frame in stack for p in patterns)


def device_s_per_batch(r: Reading, include: tuple,
                       exclude: tuple = ()) -> float | None:
    """Device seconds a batch of the operations launched under a frame of
    the port that starts with one of ``include`` and under none that
    starts with one of ``exclude`` (``"core/im2col.py"`` a file,
    ``"kernels/ssd/ops.py:ssd"`` a function).  None where the trace could
    not tie enough device time to its launches, or where nothing matched."""
    total = sum(r.by_stack.values())
    if r.layer_batches <= 0 or total <= 0:
        return None
    if r.by_stack.get(None, 0.0) > UNATTRIBUTED_MAX * total:
        return None
    secs = sum(s for stack, s in r.by_stack.items() if stack is not None
               and _matches(stack, include)
               and not _matches(stack, exclude))
    return secs / r.layer_batches if secs > 0 else None


def roofline_pct(r: Reading, bound_s: float, include: tuple,
                 exclude: tuple = ()) -> float | None:
    """``bound_s`` (the least time a batch's share of this work could
    take) over the device time that work took a batch."""
    took = device_s_per_batch(r, include, exclude)
    return None if took is None else 100.0 * bound_s / took
