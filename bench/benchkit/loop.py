"""What the loops that offer a cell's load share (``bench/loops/<name>.py``
finds them by a traffic mix's ``loop`` key), and the closed loop itself.

In the closed loop a batch is submitted (the program's entry point, which returns before
the card has finished), its answers are reduced on the card and copied to
pinned host memory behind an event, and the loop reads a batch back only
once ``in_flight`` batches are outstanding: with 2, batch i + 1 is
submitted before batch i's answers are read.  A batch's latency runs from
the call into the entry point until its answers are on the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Iterator

import torch

__all__ = ["Done", "Window", "HostCopier", "closed_loop"]


@dataclasses.dataclass
class Done:
    index: int                  # the pool batch it served
    output: torch.Tensor        # what the entry point returned, for the check
    answers: torch.Tensor       # the answers as they reached the host
    submitted: float
    done: float
    #: what this record counts, where it differs from the driver's counts
    #: of a batch (a loop of requests of their own sizes)
    counts: dict | None = None


@dataclasses.dataclass
class Window:
    batches: list[Done]
    start: float
    end: float                  # when the last batch's answers arrived

    @property
    def seconds(self) -> float:
        return self.end - self.start


class HostCopier:
    """Copies small answer tensors to the host without a synchronize: a
    ring of pinned buffers per shape, each copy followed by an event.  On
    the CPU the copy is a plain clone."""

    def __init__(self, device: torch.device, depth: int):
        self.device = torch.device(device)
        self.depth = depth
        self._rings: dict[tuple, list] = {}     # (shape, dtype) -> buffers
        self._turn = 0

    def start(self, answers: torch.Tensor):
        """Begin the copy; returns ``wait() -> host tensor``."""
        if self.device.type != "cuda":
            host = answers.detach().clone()
            return lambda: host
        key = (tuple(answers.shape), answers.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = [torch.empty(answers.shape, dtype=answers.dtype,
                                pin_memory=True) for _ in range(self.depth)]
            self._rings[key] = ring
        buf = ring[self._turn % self.depth]
        self._turn += 1
        buf.copy_(answers, non_blocking=True)
        event = torch.cuda.Event()
        event.record()

        def wait() -> torch.Tensor:
            event.synchronize()
            return buf.clone()
        return wait


def closed_loop(entry: Callable[[int], torch.Tensor],
                answer: Callable[[torch.Tensor], torch.Tensor],
                order: Iterator[int], in_flight: int, copier: HostCopier, *,
                seconds: float | None = None, count: int | None = None,
                span: Callable[[str], contextlib.AbstractContextManager]
                = lambda name: contextlib.nullcontext(),
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Batches from ``order`` through ``entry`` with ``in_flight``
    outstanding, until ``count`` have been submitted or ``seconds`` have
    passed since the first submission; then the outstanding ones are read
    back.  The window ends when the last answers arrive, so a rate over it
    takes all the work and all the time."""
    if (seconds is None) == (count is None):
        raise ValueError("closed_loop: give seconds or count")
    pending: collections.deque = collections.deque()
    done: list[Done] = []

    def read_oldest() -> None:
        index, output, wait, submitted = pending.popleft()
        with span("bench.wait"):
            host = wait()
        done.append(Done(index, output, host, submitted, clock()))

    start = clock()
    submitted = 0
    while True:
        now = clock()
        if (count is not None and submitted >= count) or (
                seconds is not None and now - start >= seconds):
            break
        index = next(order)
        with span("bench.submit"):
            output = entry(index)
            wait = copier.start(answer(output))
        pending.append((index, output, wait, now))
        submitted += 1
        if len(pending) >= in_flight:
            read_oldest()
    while pending:
        read_oldest()
    return Window(done, start, done[-1].done if done else clock())
