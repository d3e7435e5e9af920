"""``repro_torch.quant`` — the int8 quantized-engine subsystem, ported from
``repro.quant``.

Four layers:

  * :mod:`repro_torch.quant.quantize`  — the numeric scheme (symmetric
    per-output-channel int8 weights; ``quant_gemm`` runs the int8×int8
    qmm kernel when an activation scale is available, the weight-only
    fp32 product otherwise).
  * :mod:`repro_torch.quant.act`       — online activation quantization:
    per-GEMM-shape :class:`ActScale` EMAs calibrated from live batches.
  * :mod:`repro_torch.quant.engine`    — :class:`QuantizedEngine`, which
    adapts any CAP_GEMM engine into a CAP_GRAD-free ``int8`` entry.
  * :mod:`repro_torch.quant.calibrate` — measured error vs the fp32 oracle
    on the int8×int8 path; :func:`register_quantized` refuses engines
    past tolerance and installs the rate measured on the device.

Typical setup on the card::

    from repro_torch.quant import register_quantized
    register_quantized("cuda-tiled")      # 'cuda-tiled-int8' joins
    cnn_forward(cfg, params, x, job_class="decode")   # int8 GEMMs on K2
"""

from .quantize import (QuantizedWeight, dequant_epilogue, dequant_finish,
                       dequantize_weights, quant_gemm, quantization_error,
                       quantize_weights)
from .act import (ActCalibrator, ActScale, DEFAULT_MIN_UPDATES,
                  DEFAULT_MOMENTUM, one_shot_act_scale,
                  quantize_activations)
from .engine import INT8_SPEEDUP, QuantizedEngine
from .calibrate import (DEFAULT_SHAPES, DEFAULT_TOL, CalibrationError,
                        CalibrationReport, calibrate, register_quantized,
                        rel_err)

__all__ = [
    "QuantizedWeight", "quantize_weights", "dequantize_weights",
    "dequant_epilogue", "dequant_finish", "quant_gemm",
    "quantization_error",
    "ActScale", "ActCalibrator", "quantize_activations",
    "one_shot_act_scale", "DEFAULT_MOMENTUM", "DEFAULT_MIN_UPDATES",
    "QuantizedEngine", "INT8_SPEEDUP",
    "CalibrationError", "CalibrationReport", "DEFAULT_SHAPES", "DEFAULT_TOL",
    "calibrate", "register_quantized", "rel_err",
]
