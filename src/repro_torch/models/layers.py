"""Shared neural-net layers (functional, dicts of tensors).

All dense projections route through
:func:`repro_torch.core.synergy_mm.synergy_matmul`, so every GEMM in every
architecture is visible to the Synergy job tracer and runs on the
dispatcher's engine (the CUDA ``tiled_mm`` kernel for CUDA tensors).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.synergy_mm import synergy_matmul

__all__ = ["rms_norm", "layer_norm", "rope", "dense", "glu_mlp",
           "init_dense", "init_glu_mlp", "softmax_xent", "normal", "MetaKey"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding.  x (..., S, D) with D even; positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# init helpers / dense / MLP
# ---------------------------------------------------------------------------

class MetaKey:
    """Takes a ``torch.Generator``'s place in init on the ``meta`` device
    (which has no generator): :func:`normal` draws nothing from it."""

    device = torch.device("meta")


def normal(g: torch.Generator | MetaKey, shape: tuple, scale: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) of ``shape`` drawn from ``g`` on ``g``'s device, cast
    to ``dtype``; on the ``meta`` device an empty stand-in."""
    if g.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=g, device=g.device)
            * scale).to(dtype)


def init_dense(g: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               scale: float | None = None, *, lead: tuple = ()
               ) -> torch.Tensor:
    """A (d_in, d_out) weight, or ``lead + (d_in, d_out)`` for a stack."""
    scale = scale if scale is not None else d_in ** -0.5
    return normal(g, (*lead, d_in, d_out), scale, dtype)


def dense(x: torch.Tensor, w: torch.Tensor, name: str = "dense",
          **kw) -> torch.Tensor:
    return synergy_matmul(x, w, name=name, **kw)


_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_glu_mlp(g: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32, *,
                 lead: tuple = ()) -> dict:
    return {
        "wi": init_dense(g, d_model, 2 * d_ff, dtype, lead=lead),  # gate|up
        "wo": init_dense(g, d_ff, d_model, dtype, lead=lead),
    }


def glu_mlp(params: dict, x: torch.Tensor, act: str = "silu",
            name: str = "mlp") -> torch.Tensor:
    """SwiGLU (act='silu', llama-style) or GeGLU (act='gelu', gemma-style)."""
    h = dense(x, params["wi"], name=f"{name}/wi")
    gate, up = torch.chunk(h, 2, dim=-1)
    return dense(_ACTS[act](gate) * up, params["wo"], name=f"{name}/wo")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) fp32-softmaxed."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss
