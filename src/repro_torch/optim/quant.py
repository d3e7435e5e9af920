"""Weight-only int8 quantization for serving (§Perf B1/B2 production path).

Per-output-channel symmetric scales (the standard weight-only scheme):
matmul weights (d_in, d_out) quantize along d_in.  ``quantize_params``
walks a param tree and quantizes every >=2D matmul weight, leaving norms,
biases and embeddings' scales attached; ``QuantizedLinear`` application is
``(x @ q.to(bf16)) * scale``.

The NUMERIC core lives in :mod:`repro_torch.quant.quantize` (the
quantized-engine subsystem); this module is the param-tree view of the
same scheme, plus the tuple-based API the serving path predates — bit for
bit ``repro``'s.  ``quant_matmul``'s product is a plain matmul, as in
``repro`` (outside any kernel there too).
"""

from __future__ import annotations

import torch

from repro_torch.quant.quantize import quantize_weights as _quantize_weights

__all__ = ["quantize_weight", "dequantize_weight", "quantize_params",
           "quant_matmul"]


def quantize_weight(w: torch.Tensor):
    """w (..., d_in, d_out) -> (q int8, scale (..., 1, d_out) f32)."""
    qw = _quantize_weights(w)
    return qw.q, qw.scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """act(x) @ dequant(q) with the scale applied as an epilogue:
    (x @ q) * scale, the product of x's dtype accumulated in fp32."""
    f32 = torch.float32
    y = torch.matmul(x.to(f32), q.to(x.dtype).to(f32))
    return (y * scale.reshape(1, -1).to(f32)).to(x.dtype)


_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wi", "w1", "w2", "lm_head",
                  "in_proj", "out_proj", "wz", "wx", "wbc", "wdt")


def _is_matmul_weight(path: str, v: torch.Tensor) -> bool:
    if v.dim() < 2 or v.dtype == torch.int32:
        return False
    return path.split("/")[-1] in _MATMUL_LEAVES


def quantize_params(params):
    """-> tree where matmul weights become {"q": int8, "scale": f32};
    everything else passes through.  Structure-compatible consumers use
    ``dequantize_weight`` / ``quant_matmul``."""
    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if _is_matmul_weight(path, node):
            q, s = quantize_weight(node)
            return {"q": q, "scale": s}
        return node

    return walk(params, "")
