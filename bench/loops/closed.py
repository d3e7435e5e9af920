"""The closed loop over a pool of batches (:func:`benchkit.loop.closed_loop`).

Keys of a mix that it reads:

- ``batch``: requests in one batch (frames, or prompts), which the
  driver draws;
- ``pool``: distinct batches made at set-up from the seed, which the
  window cycles through in order, so that every seed gives the same sizes
  and the same arrivals and only the values differ;
- ``in_flight``: batches submitted and not yet read back (batch i + 1 is
  submitted before batch i's answers are read where it is 2);
- ``warmup_batches``: batches run before the window, all of the window's
  shape.
"""

from __future__ import annotations

import itertools

from benchkit.loop import HostCopier, closed_loop

KEYS = {"batch", "pool", "in_flight", "warmup_batches"}


def check(mix: dict) -> None:
    for key in sorted(KEYS):
        if not (isinstance(mix.get(key), int) and mix[key] >= 1):
            raise ValueError(f"traffic mix: {key} must be an int >= 1, "
                             f"got {mix.get(key)!r}")


class ClosedLoop:
    """The pool in turn, ``in_flight`` batches outstanding; the warm-up
    and every window continue one cycle."""

    def __init__(self, setup, mix: dict, device):
        self.setup, self.mix = setup, mix
        self.order = itertools.cycle(range(mix["pool"]))
        self.copier = HostCopier(device, mix["in_flight"] + 1)

    def warmup(self) -> None:
        self.window(count=self.mix["warmup_batches"])

    def window(self, **kw):
        return closed_loop(self.setup.entry, self.setup.answer, self.order,
                           self.mix["in_flight"], self.copier, **kw)


def make(setup, mix: dict, device) -> ClosedLoop:
    return ClosedLoop(setup, mix, device)
