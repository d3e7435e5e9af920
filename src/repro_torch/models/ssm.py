"""Mamba2 block (SSD) — used by mamba2-130m and the zamba2 hybrid.

Block layout (Dao & Gu 2024): projections -> [z | x | B | C | dt], causal
depthwise conv1d over x and (B,C), SiLU, SSD scan (the CUDA kernel K5, or
the chunked torch path), gated RMSNorm (y * silu(z)), out projection.

The x/z tensors are kept STRUCTURED as (..., H, P) and the projections are
separate structured weights, as in ``repro`` (whose layout serves a 16-way
tensor-parallel mesh), so parameters carry across key for key.  The
projection einsums are plain products that ``repro`` also leaves outside
any Pallas kernel.

In a mesh step P is split over 'model' (``wz``, ``wx``, ``conv_wx``,
``norm_scale``, ``out_proj``, the ``ssm`` state and ``conv_x`` hold this
rank's share; ``wbc``, ``wdt``, ``a_log``, ``dt_bias``, ``d_skip`` and the
B/C conv are whole).  P is a batch dimension of the scan, so the SSD (K5
at the rank's P) needs nothing from the other ranks.  Two sums cross
'model': the row-parallel out-projection, and the gated RMSNorm, whose
mean of squares runs over the whole (H, P), so each rank's sum of squares
is summed before the ``rsqrt``.  (``repro``'s docstring counts only the
out-projection: XLA partitions the norm's reduction implicitly.)  Under
autograd the gradient of everything whole that feeds the rank's share of
P is a part on each rank and is summed over 'model' (f): the block's
input, the norm's mean of squares, and the whole leaves (``wbc``,
``wdt``, ``conv_wbc``, ``a_log``, ``dt_bias``, ``d_skip``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd
from .layers import MetaKey, init_dense, normal
from .partition import copy_to_model, model_axis, reduce_from_model

__all__ = ["init_mamba2", "mamba2_block", "mamba2_decode_step",
           "init_mamba2_state", "CONV_K"]

CONV_K = 4


def init_mamba2(g: torch.Generator, d_model: int, d_inner: int,
                ssm_state: int, head_dim: int,
                dtype: torch.dtype = torch.float32, *,
                lead: tuple = ()) -> dict:
    h = d_inner // head_dim
    n = ssm_state
    scale = d_model ** -0.5
    dev = g.device

    def w3(out_a, out_b):
        return normal(g, (*lead, d_model, out_a, out_b), scale, dtype)

    def per_layer(t: torch.Tensor) -> torch.Tensor:
        return t.expand(*lead, *t.shape).clone()

    return {
        "wz": w3(h, head_dim),
        "wx": w3(h, head_dim),
        "wbc": init_dense(g, d_model, 2 * n, dtype, lead=lead),
        "wdt": init_dense(g, d_model, h, dtype, lead=lead),
        "conv_wx": normal(g, (*lead, CONV_K, h, head_dim), 1 / CONV_K,
                          dtype),
        "conv_wbc": normal(g, (*lead, CONV_K, 2 * n), 1 / CONV_K, dtype),
        "a_log": per_layer(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=dev))),
        "d_skip": per_layer(torch.ones((h,), dtype=torch.float32,
                                       device=dev)),
        "dt_bias": per_layer(torch.zeros((h,), dtype=torch.float32,
                                         device=dev)),
        "norm_scale": per_layer(torch.ones((h, head_dim), dtype=dtype,
                                           device=dev)),
        "out_proj": normal(g, (*lead, h, head_dim, d_model),
                           d_inner ** -0.5, dtype),
    }


def _gated_rms_hp(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float, head_dim: int) -> torch.Tensor:
    """RMSNorm over the full (H, P) inner dim of y * silu(z).  Where y
    holds this rank's share of P (``head_dim``, the whole P, larger), the
    sum of squares is summed over 'model' before the mean."""
    dt = y.dtype
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if y.shape[-1] == head_dim:
        var = torch.mean(torch.square(g), dim=(-2, -1), keepdim=True)
    else:
        # g, then f: the whole sum feeds this rank's share of P
        axis = model_axis()
        var = copy_to_model(reduce_from_model(
            torch.sum(torch.square(g), dim=(-2, -1), keepdim=True), axis),
            axis) / (y.shape[-2] * head_dim)
    return (g * torch.rsqrt(var + eps) * scale).to(dt)


def _out_proj(y: torch.Tensor, w: torch.Tensor, head_dim: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The out-projection over (H, P), row-parallel: summed over 'model'
    where y holds this rank's share of P."""
    out = torch.einsum("blhp,hpd->bld", y, w.to(y.dtype))
    if y.shape[-1] != head_dim:
        out = reduce_from_model(out, model_axis())
    return out.to(dtype)


@functools.lru_cache(maxsize=None)
def _whole_shapes(d_model: int, d_inner: int, ssm_state: int,
                  head_dim: int) -> dict:
    """Each mixer leaf's shape for one layer, whole."""
    meta = init_mamba2(MetaKey(), d_model, d_inner, ssm_state, head_dim)
    return {k: tuple(v.shape) for k, v in meta.items()}


def _enter_partitioned(params: dict, x: torch.Tensor, axis, *,
                       d_inner: int, ssm_state: int, head_dim: int):
    """(``params``, ``x``) with f (:func:`copy_to_model`) on ``x`` and on
    every leaf that this rank holds whole though P is split: each feeds
    this rank's share of P only, so each rank's gradient is a part.  A
    leaf is whole where its shape is the whole one, so ``param_pspecs``
    stays the one place that decides."""
    whole = _whole_shapes(x.shape[-1], d_inner, ssm_state, head_dim)
    return ({k: copy_to_model(v, axis) if tuple(v.shape) == whole[k] else v
             for k, v in params.items()}, copy_to_model(x, axis))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold, as jax.nn.softplus computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _projections(params: dict, x: torch.Tensor):
    dt = x.dtype
    z = torch.einsum("bld,dhp->blhp", x, params["wz"].to(dt))
    xs = torch.einsum("bld,dhp->blhp", x, params["wx"].to(dt))
    bc = torch.einsum("bld,dn->bln", x, params["wbc"].to(dt))
    dtp = torch.einsum("bld,dh->blh", x, params["wdt"].to(dt))
    return z, xs, bc, dtp


def mamba2_block(params: dict, x: torch.Tensor, *, d_inner: int,
                 ssm_state: int, head_dim: int, chunk: int = 128,
                 eps: float = 1e-5, impl: str = "auto",
                 name: str = "mamba") -> torch.Tensor:
    """x (B, L, d) -> (B, L, d)."""
    b, l, _ = x.shape
    n = ssm_state
    axis = model_axis()
    if axis is not None and params["wx"].shape[-1] != head_dim:
        params, x = _enter_partitioned(params, x, axis, d_inner=d_inner,
                                       ssm_state=n, head_dim=head_dim)

    z, xs, bc, dt = _projections(params, x)

    # causal depthwise conv1d (kernel CONV_K), structured for x / flat for BC
    xs_p = F.pad(xs, (0, 0, 0, 0, CONV_K - 1, 0))
    xs = sum(xs_p[:, i:i + l] * params["conv_wx"][i][None, None]
             for i in range(CONV_K))
    bc_p = F.pad(bc, (0, 0, CONV_K - 1, 0))
    bc = sum(bc_p[:, i:i + l] * params["conv_wbc"][i][None, None]
             for i in range(CONV_K))
    xs = F.silu(xs)
    bc = F.silu(bc)
    bm, cm = bc[..., :n], bc[..., n:]

    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, _ = ssd(xs, dt, a, bm, cm, chunk=chunk, impl=impl)   # (B,L,H,P)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = _gated_rms_hp(y, z, params["norm_scale"], eps, head_dim)
    return _out_proj(y, params["out_proj"], head_dim, x.dtype)


def init_mamba2_state(batch: int, d_inner: int, ssm_state: int,
                      head_dim: int, dtype: torch.dtype = torch.float32, *,
                      lead: tuple = (), device=None) -> dict:
    h = d_inner // head_dim
    return {
        "conv_x": torch.zeros((*lead, batch, CONV_K - 1, h, head_dim),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((*lead, batch, CONV_K - 1, 2 * ssm_state),
                               dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, h, head_dim, ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode_step(params: dict, x: torch.Tensor, state: dict, *,
                       d_inner: int, ssm_state: int, head_dim: int,
                       eps: float = 1e-5, name: str = "mamba"):
    """One-token decode.  x (B, 1, d) -> (y (B, 1, d), new state)."""
    n = ssm_state
    f32 = torch.float32

    z, xs, bc, dt = _projections(params, x)

    win_x = torch.cat([state["conv_x"], xs], dim=1)             # (B,K,H,P)
    win_bc = torch.cat([state["conv_bc"], bc], dim=1)           # (B,K,2N)
    xs1 = F.silu((win_x * params["conv_wx"][None]).sum(dim=1))
    bc1 = F.silu((win_bc * params["conv_wbc"][None]).sum(dim=1))
    bm, cm = bc1[..., :n], bc1[..., n:]

    dt1 = _softplus(dt[:, 0].to(f32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt1 * a[None, :])                         # (B,H)
    xdt = xs1.to(f32) * dt1[..., None]                          # (B,H,P)
    s = state["ssm"] * decay[..., None, None] + (
        xdt[..., :, None] * bm[:, None, None, :])               # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", s, cm.to(f32))
    y = y + params["d_skip"][None, :, None] * xs1.to(f32)
    y = _gated_rms_hp(y[:, None].to(x.dtype), z,
                      params["norm_scale"], eps, head_dim)      # (B,1,H,P)
    out = _out_proj(y, params["out_proj"], head_dim, x.dtype)
    return out, {"conv_x": win_x[:, 1:], "conv_bc": win_bc[:, 1:], "ssm": s}
