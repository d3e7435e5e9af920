"""Mixture-of-Experts FFN (dbrx, kimi-k2) — Synergy job view: each expert's
FFN GEMMs are tile-job sets; routing decides which jobs exist per step.

Dispatch is **expert-choice with per-group capacity** (Zhou et al.), as in
``repro``: within each token group, every expert picks its top-C tokens by
router score.  All shapes stay static (C = T·k·cf/E) and no sorting
network is needed.  Token-choice top-k (the dbrx/kimi papers' routing) is
kept as a small-scale oracle (``moe_ffn_tc``).  Plain torch: no kernel.

In a mesh step the experts are split over 'model' (``w1``/``w2`` hold
this rank's E/R): every rank routes with the whole router, runs only its
experts' tokens and sums the partial outputs over 'model' (expert
parallelism; the tokens are on every rank already).

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently;
ties are improbable on random float router scores, so the two packages
pick the same tokens in the conformance tests.
"""

from __future__ import annotations

import torch

from .layers import _ACTS, init_dense, normal
from .partition import copy_to_model, model_axis, reduce_from_model

__all__ = ["init_moe", "moe_ffn", "moe_ffn_tc", "ec_capacity"]


def init_moe(g: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype = torch.float32, *,
             lead: tuple = ()) -> dict:
    return {
        "router": init_dense(g, d_model, n_experts, torch.float32,
                             lead=lead),
        "w1": normal(g, (*lead, n_experts, d_model, 2 * d_ff),
                     d_model ** -0.5, dtype),
        "w2": normal(g, (*lead, n_experts, d_ff, d_model), d_ff ** -0.5,
                     dtype),
    }


def ec_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    c = int(tokens_per_group * top_k * capacity_factor / n_experts)
    c = -(-max(c, 1) // 4) * 4          # round up to a multiple of 4
    return max(1, min(tokens_per_group, c))


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            name: str = "moe") -> torch.Tensor:
    """Expert-choice MoE.  x (G, T, d) — G token groups (batch dim for
    train/prefill; a single group for decode).  Returns (G, T, d)."""
    g, t, d = x.shape
    router = params["router"]
    e = router.shape[1]
    c = ec_capacity(t, e, top_k, capacity_factor)
    e_mine = params["w1"].shape[0]
    axis = model_axis() if e_mine != e else None
    if axis is not None:
        # the tokens and the whole router feed this rank's experts only:
        # a part of their gradient on each rank
        x, router = copy_to_model(x, axis), copy_to_model(router, axis)

    logits = torch.einsum("gtd,de->gte", x.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)                      # (G,T,E)
    gate, idx = torch.topk(probs.transpose(1, 2), c, dim=-1)   # (G,E,C)

    if axis is not None:
        # a mesh step: this rank's experts only (the router is whole, so
        # every rank made the same choice); their outputs summed below
        lo = axis.rank * e_mine
        gate, idx = gate[:, lo:lo + e_mine], idx[:, lo:lo + e_mine]

    rows = torch.arange(g, device=x.device)[:, None, None]
    xe = x[rows, idx]                                          # (G,E,C,d)
    # products in x's dtype with fp32 sums; the hidden activation is
    # rounded to x's dtype, the expert outputs stay fp32
    f32, dt = torch.float32, x.dtype
    h = torch.einsum("gecd,edf->gecf", xe.to(f32),
                     params["w1"].to(dt).to(f32)).to(dt)
    gate_h, up = torch.chunk(h, 2, dim=-1)
    h = _ACTS[act](gate_h) * up
    o = torch.einsum("gecf,efd->gecd", h.to(f32),
                     params["w2"].to(dt).to(f32))
    o = o * gate[..., None].to(o.dtype)

    y = torch.zeros((g * t, d), dtype=o.dtype, device=x.device)
    flat = (idx + rows * t).reshape(-1)
    y.index_add_(0, flat, o.reshape(-1, d))
    if axis is not None:
        y = reduce_from_model(y, axis)
    return y.reshape(g, t, d).to(x.dtype)


def moe_ffn_tc(params: dict, x: torch.Tensor, *, top_k: int,
               act: str = "silu") -> torch.Tensor:
    """Token-choice top-k oracle (dense over experts — small scale only).
    Every token's output = sum of its top-k experts weighted by the
    normalized router probabilities (dbrx/kimi routing semantics)."""
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32),
                          params["router"])
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # (G,T,K)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # dense compute of all experts, then gather the chosen ones
    h = torch.einsum("gtd,edf->gtef", x, params["w1"])
    gate_h, up = torch.chunk(h, 2, dim=-1)
    h = _ACTS[act](gate_h) * up
    o = torch.einsum("gtef,efd->gted", h, params["w2"])        # (G,T,E,d)
    sel = torch.gather(o, 2, topi[..., None].expand(*topi.shape,
                                                    o.shape[-1]))
    return (sel * topv[..., None].to(sel.dtype)).sum(dim=2).to(x.dtype)
