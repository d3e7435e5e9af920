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
from .partition import (all_reduce_max, copy_to_model, glu_regroup,
                        model_axis, reduce_from_model)

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
            name: str = "mlp", *, d_ff: int) -> torch.Tensor:
    """SwiGLU (act='silu', llama-style) or GeGLU (act='gelu', gemma-style).

    In a mesh step ``wi``'s columns and ``wo``'s rows may be this rank's
    'model' shards of the global ``d_ff``: see
    :func:`_glu_mlp_partitioned`."""
    axis = model_axis()
    if axis is not None and params["wi"].shape[-1] != 2 * d_ff:
        return _glu_mlp_partitioned(params, x, act, name, d_ff, axis)
    h = dense(x, params["wi"], name=f"{name}/wi")
    gate, up = torch.chunk(h, 2, dim=-1)
    return dense(_ACTS[act](gate) * up, params["wo"], name=f"{name}/wo")


def _glu_mlp_partitioned(params: dict, x: torch.Tensor, act: str, name: str,
                         d_ff: int, axis) -> torch.Tensor:
    """The GLU MLP with ``wi`` split over 'model' in contiguous column
    blocks (``repro``'s layout: rank s holds blocks 2s, 2s + 1 of
    ``[gate | up]``) and ``wo``'s rows split by ``d_ff`` (Megatron's
    column- then row-parallel pair).  Each rank takes ``gate`` and ``up``
    for its ``wo`` rows by one all-to-all (:func:`glu_regroup`) of its
    ``wi`` shard or of the activations it makes, whichever is fewer
    bytes at this call's token count, and the row-parallel products are
    summed over 'model'."""
    wi, wo = params["wi"], params["wo"]
    if wo.shape[0] == d_ff:
        raise ValueError(f"GLU MLP layout: wi split over 'model' "
                         f"({wi.shape[-1]} of {2 * d_ff} columns) with "
                         f"wo's {d_ff} rows whole")
    d, width = wi.shape[0], wi.shape[-1] // 2
    x = copy_to_model(x, axis)
    tokens = x.numel() // x.shape[-1]
    if tokens * x.element_size() < d * wi.element_size():
        h = dense(x, wi, name=f"{name}/wi")
        lead = h.shape[:-1]
        blocks = h.reshape(tokens, 2, width).transpose(0, 1)
        gate, up = glu_regroup(blocks.contiguous(), axis)
        gate, up = gate.reshape(*lead, width), up.reshape(*lead, width)
    else:
        blocks = wi.reshape(d, 2, width).transpose(0, 1).contiguous()
        mine = glu_regroup(blocks, axis).transpose(0, 1).reshape(d, 2 * width)
        gate, up = torch.chunk(dense(x, mine, name=f"{name}/wi"), 2, dim=-1)
    y = dense(_ACTS[act](gate) * up, wo, name=f"{name}/wo")
    return reduce_from_model(y, axis)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0, *, vocab: int | None = None
                 ) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) fp32-softmaxed.  In a
    mesh step whose logits hold this rank's columns of the ``vocab``
    (rank r the r-th block), see :func:`_vocab_parallel_xent`."""
    axis = model_axis()
    if axis is not None and vocab is not None and logits.shape[-1] != vocab:
        return _vocab_parallel_xent(logits, labels, z_loss, axis)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss


def _vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                         z_loss: float, axis) -> torch.Tensor:
    """:func:`softmax_xent` of logits split on the vocabulary over
    'model', from three sums over 'model': the row maximum (detached,
    as ``logsumexp`` holds it), the row's sum of exponentials (``lse``
    over every column, padding included) and the label's logit, taken by
    the rank whose columns hold it.  Every rank gets the same loss."""
    logits = logits.to(torch.float32)
    cols = logits.shape[-1]
    top = all_reduce_max(logits.amax(dim=-1, keepdim=True), axis.group)
    sums = reduce_from_model(torch.exp(logits - top).sum(dim=-1), axis)
    lse = top[..., 0] + torch.log(sums)
    local = labels.long() - axis.rank * cols
    mine = (local >= 0) & (local < cols)
    picked = torch.gather(logits, -1,
                          torch.where(mine, local, 0)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(mine, picked, 0.0), axis)
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss
