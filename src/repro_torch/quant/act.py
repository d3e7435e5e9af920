"""Online activation quantization — per-tensor int8 scales calibrated
from live decode batches (``repro.quant.act``, ported).

Weight scales are known offline; activation ranges are a property of the
TRAFFIC, so they are learned online.  Per GEMM shape, an exponential
moving average of the per-batch max |a| gives one symmetric per-tensor
scale ``amax / 127``.  Once a shape has seen ``min_updates`` batches the
scale is published and the quantized engine family's int8×int8 path
switches on for that shape; until then execution takes the weight-only
path.

Determinism: calibration is a pure fold over the observation sequence,
kept in Python floats (doubles) on the host, as ``repro`` keeps it — same
batches in the same order give bit-identical scales.  A live calibrator
moves with every batch (``0.9·a + 0.1·a`` need not round back to ``a``),
so bitwise run-to-run comparisons start from one ``export_state``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Hashable, Optional

import torch

__all__ = ["ActScale", "ActCalibrator", "quantize_activations",
           "one_shot_act_scale", "DEFAULT_MOMENTUM", "DEFAULT_MIN_UPDATES"]

_QMAX = 127.0

#: EMA momentum: high enough to ride out one outlier batch, low enough
#: that a few decode steps converge the range
DEFAULT_MOMENTUM = 0.9

#: batches a shape must contribute before its scale is published
DEFAULT_MIN_UPDATES = 1


@dataclasses.dataclass(frozen=True)
class ActScale:
    """Calibrated activation range of one GEMM shape.

    ``amax``    EMA of per-batch max |a|.
    ``updates`` batches folded in so far.
    """

    amax: float
    updates: int

    @property
    def scale(self) -> float:
        """Symmetric per-tensor int8 scale: ``a ~= q * scale``."""
        return max(self.amax, 1e-12) / _QMAX


def _amax(a: torch.Tensor) -> float:
    """max |a| as a Python float: one host sync on the card."""
    return float(a.abs().amax())


def one_shot_act_scale(a: torch.Tensor) -> float:
    """The scale one batch implies on its own — ``max|a| / 127``, i.e.
    :class:`ActScale` after a single observation."""
    return _amax(a) / _QMAX


def quantize_activations(a: torch.Tensor, scale: float) -> torch.Tensor:
    """a -> symmetric per-tensor int8 at the calibrated scale (a Python
    float).  Values beyond the calibrated range saturate at ±127.  The
    scale is rounded to float32 and divides as a 0-dim tensor on a's
    device: a true division on the card too (a Python-float divisor would
    become a multiply by its reciprocal there)."""
    s = torch.full((), float(scale), dtype=torch.float32, device=a.device)
    return torch.round(a.to(torch.float32) / s).clamp(
        -_QMAX, _QMAX).to(torch.int8)


class ActCalibrator:
    """Per-GEMM-shape online range calibrator.

    ``observe(a, key)`` folds one live batch into the shape's EMA;
    ``scale_for(key)`` returns the published scale (a Python float) or
    None while the shape is still warming up.  Thread-safe: runtime
    workers and serving threads observe concurrently."""

    def __init__(self, momentum: float = DEFAULT_MOMENTUM,
                 min_updates: int = DEFAULT_MIN_UPDATES):
        self.momentum = momentum
        self.min_updates = min_updates
        self._scales: dict[Hashable, ActScale] = {}
        self._lock = threading.Lock()

    def observe(self, a: torch.Tensor, key: Hashable) -> ActScale:
        """Fold one activation batch into ``key``'s EMA.  The
        ``float(max|a|)`` is a host sync: the very next step quantizes at
        the scale this observation publishes.  The runtime pays it once per
        submission (panels reuse one quantization)."""
        return self.observe_amax(_amax(a), key)

    def observe_amax(self, amax: float, key: Hashable) -> ActScale:
        """Fold one precomputed per-batch ``max|a|`` into ``key``'s EMA —
        the same pure fold as :meth:`observe`, for a caller that reduced
        on the device earlier and reads the float later."""
        with self._lock:
            prev = self._scales.get(key)
            if prev is None:
                cur = ActScale(amax=amax, updates=1)
            else:
                cur = ActScale(
                    amax=self.momentum * prev.amax
                    + (1.0 - self.momentum) * amax,
                    updates=prev.updates + 1)
            self._scales[key] = cur
            return cur

    def scale_for(self, key: Hashable) -> Optional[float]:
        """The published per-tensor scale for ``key``, or None while the
        shape has fewer than ``min_updates`` observations."""
        with self._lock:
            s = self._scales.get(key)
        if s is None or s.updates < self.min_updates:
            return None
        return s.scale

    def state(self) -> dict:
        """Snapshot of every calibrated shape (diagnostics)."""
        with self._lock:
            return dict(self._scales)

    def export_state(self) -> list:
        """JSON-safe dump of every shape's EMA.  Tuple keys serialize as
        lists and :meth:`import_state` turns them back."""
        with self._lock:
            return [[list(k) if isinstance(k, tuple) else k,
                     s.amax, s.updates]
                    for k, s in self._scales.items()]

    def import_state(self, state: list) -> None:
        """Restore :meth:`export_state` output — restored scales resume
        the exact EMA trajectory (same floats, same update counts)."""
        with self._lock:
            self._scales = {
                tuple(k) if isinstance(k, list) else k:
                    ActScale(amax=float(amax), updates=int(updates))
                for k, amax, updates in state}

    def reset(self) -> None:
        with self._lock:
            self._scales.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._scales)

    def __repr__(self) -> str:
        return (f"<ActCalibrator {len(self)} shapes "
                f"momentum={self.momentum} min_updates={self.min_updates}>")
