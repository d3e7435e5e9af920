"""QuantizedEngine — adapt any CAP_GEMM engine into an int8 variant
(``repro.quant.engine``, ported).

The same physical backend shows up twice in the registry, once at full
precision and once as a CAP_GRAD-free ``int8`` engine, with two compute
paths:

  * **int8×int8 path**: once the engine's
    :class:`~repro_torch.quant.act.ActCalibrator` has published a
    per-tensor activation scale for a GEMM shape, ``execute`` quantizes
    the activations and runs the qmm kernel (K2) — int8 operands, exact
    int32 accumulation, dequant (w_scale × act_scale) + bias + activation
    fused into the epilogue.
  * **weight-only fallback**: shapes still warming up (or a disabled
    calibrator) cast the int8 weights up into the BASE engine's floating
    GEMM, with the dequant applied as a separate tail.

Calibration is ONLINE: every ``execute`` folds its activation batch into
the EMA before routing.

Capability surgery on wrap:

  * ``+ int8``     — the dispatcher's decode policy prefers these.
  * ``- grad``     — round/clip have zero gradient almost everywhere, so a
    quantized path silently kills weight gradients.
  * ``- oracle``   — a lossy engine is never a numerical reference.
  * ``- epilogue`` — the weight-only fallback applies dequant -> bias ->
    activation as a separate pass over C.

Cost model: the base engine's model on the operands' device, scaled by
``speedup``, until ``register_quantized`` (or runtime recalibration)
installs a measured rate.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable, Optional

import torch

from repro_torch.engines.base import (CAP_EPILOGUE, CAP_GRAD, CAP_INT8,
                                      CAP_ORACLE, CostModel, Engine)

from .act import ActCalibrator
from .quantize import (QuantizedWeight, dequant_finish, quant_gemm,
                       quantize_weights)

__all__ = ["QuantizedEngine", "INT8_SPEEDUP"]

#: nominal rate advantage of the int8 path over its fp32 base — only the
#: STARTING cost model: ``register_quantized`` replaces it with the rate
#: measured on the qmm kernel for non-sim bases
INT8_SPEEDUP = 4.0

#: weight-cache capacity (decode reuses the same handful of weights)
_CACHE_SLOTS = 32


class QuantizedEngine(Engine):
    """Int8 view of a wrapped full-precision engine.

    ``calibrator`` owns the per-shape activation scales ("auto" builds a
    private :class:`ActCalibrator`; None pins the engine to the
    weight-only fallback; share one instance across engines so they
    calibrate the same EMAs).

    ``calibration`` is attached by :func:`repro_torch.quant.calibrate.
    calibrate` / ``register_quantized`` — the quant-error metadata that
    travels with the cost model."""

    def __init__(self, base: Engine, *, name: str | None = None,
                 speedup: float = INT8_SPEEDUP,
                 cost: CostModel | None = None,
                 calibrator: ActCalibrator | str | None = "auto"):
        caps = (base.capabilities
                - {CAP_GRAD, CAP_ORACLE, CAP_EPILOGUE}) | {CAP_INT8}
        super().__init__(name or f"{base.name}-int8", caps, cost=cost)
        self.base = base
        self.speedup = speedup
        self.calibrator = (ActCalibrator() if calibrator == "auto"
                           else calibrator)
        #: CalibrationReport once calibrated (quant-error metadata)
        self.calibration = None
        # identity-keyed LRU: holding the key tensor alive guarantees its
        # id() cannot be reused while the entry exists
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_lock = threading.Lock()

    def cost_on(self, device) -> CostModel:
        if self._cost is not None:       # measured or recalibrated rate
            return self._cost
        return self.base.cost_on(device).scaled(self.speedup)

    def available(self) -> bool:
        return self.base.available()

    # ------------------------------------------------------------- weights
    def quantized(self, b: torch.Tensor) -> QuantizedWeight:
        """Quantize (or fetch the cached quantization of) one weight."""
        key = id(b)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] is b:
                self._cache.move_to_end(key)
                return hit[1]
        qw = quantize_weights(b)
        with self._cache_lock:
            self._cache[key] = (b, qw)
            self._cache.move_to_end(key)
            while len(self._cache) > _CACHE_SLOTS:
                self._cache.popitem(last=False)
        return qw

    # --------------------------------------------------------- activations
    @staticmethod
    def act_key(k: int, n: int) -> Hashable:
        """Activation scales are keyed per GEMM shape by the WEIGHT'S
        (k, n): the batch dimension varies step to step, but a layer's
        activation statistics belong to the layer."""
        return (int(k), int(n))

    def observe_activations(self, a: torch.Tensor, k: int, n: int) -> None:
        """Fold one live activation batch into the (k, n) shape's EMA."""
        if self.calibrator is not None:
            self.calibrator.observe(a, self.act_key(k, n))

    def observe_amax(self, amax: float, k: int, n: int) -> None:
        """Fold a precomputed batch ``max|a|`` into the (k, n) EMA."""
        if self.calibrator is not None:
            self.calibrator.observe_amax(float(amax), self.act_key(k, n))

    def act_scale_for(self, k: int, n: int) -> Optional[float]:
        """The published activation scale for a (k, n) GEMM shape, or
        None while it is warming up (weight-only fallback applies)."""
        if self.calibrator is None:
            return None
        return self.calibrator.scale_for(self.act_key(k, n))

    # ------------------------------------------------------------- execute
    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        k, n = b.shape
        self.observe_activations(a, k, n)
        scale = self.act_scale_for(k, n)
        if scale is not None:
            # the TRUE int8×int8 path: quantized operands into the qmm
            # kernel, int32 accumulation, fused dequant epilogue
            return quant_gemm(a, self.quantized(b), act_scale=scale,
                              bias=bias, activation=activation,
                              out_dtype=out_dtype or a.dtype)
        return self.execute_weight_only(a, b, bias=bias,
                                        activation=activation, tile=tile,
                                        out_dtype=out_dtype)

    def execute_weight_only(self, a, b, *, bias=None,
                            activation: Callable | None = None,
                            tile=(256, 256, 256), out_dtype=None):
        """The weight-only path, with NO online observation and no chance
        of flipping onto the int8×int8 kernel mid-flight: int8 weights
        cast up into the base engine's floating GEMM, dequant applied as
        the shared tail.  The runtime's precision-pinned mixed-pool splits
        call this directly — a path choice that depended on concurrent
        panel completion order would make the merged numerics a function
        of thread timing."""
        qw = self.quantized(b)
        acc = self.base.execute(a, qw.q.to(a.dtype), bias=None,
                                activation=None, tile=tile,
                                out_dtype=torch.float32)
        return dequant_finish(acc, qw, bias=bias, activation=activation,
                              out_dtype=out_dtype or a.dtype)

    def execute_int8(self, a_q: torch.Tensor, qw: QuantizedWeight, *,
                     tile=(256, 256, 256)) -> torch.Tensor:
        """Raw int8×int8 partial: the int32 accumulator with NO dequant.
        The SynergyRuntime splits a quantized GEMM into row panels in
        this mode — integer partials are exact on every engine, so the
        merge concatenates them and applies ``dequant_finish`` ONCE."""
        from repro_torch.kernels.qmm import qmm_matmul
        return qmm_matmul(a_q, qw.q, qw.scale, fuse_dequant=False)

    def __repr__(self) -> str:
        caps = ",".join(sorted(self.capabilities))
        return (f"<QuantizedEngine {self.name!r} base={self.base.name!r} "
                f"[{caps}]>")
