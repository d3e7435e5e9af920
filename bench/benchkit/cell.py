"""What a cell's driver (``bench/models/<driver>.py``) hands the run.

A driver is a module with ``setup(config, traffic, seed, device,
reference) -> Setup``, where ``reference`` is the cell's plain reference
module, and ``TRAFFIC_KEYS``, the keys of a traffic mix it reads beyond
its loop's, where there are any.  The ``Setup`` holds the timed entry
point over the pool, how a batch's answers are reduced for the host, the
work a batch counts, the check of the window's outputs against the plain
reference, and the controls."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Setup"]


@dataclasses.dataclass
class Setup:
    #: the timed path: pool batch index -> the program's output (on the card)
    entry: Callable[[int], torch.Tensor]
    #: output -> the small tensor of answers copied to the host
    answer: Callable[[torch.Tensor], torch.Tensor]
    #: what one batch counts: {"frames": 256} or {"requests": 4, ...}
    counts: dict[str, int]
    #: the window's batches (``loop.Done``) -> {number compared: reading}
    check: Callable[[list], dict[str, float]]
    #: rounding name -> the plain reference at that precision, in the
    #: entry point's place (the control)
    control: Callable[[str], Callable[[int], torch.Tensor]]
