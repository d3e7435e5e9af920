"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment — the memory-sane optimizer for the 132B/1T MoE archs (second-moment
storage drops from O(params) fp32 to O(rows + cols)).  ``repro``'s update
leaf for leaf; ``inplace=True`` writes each leaf's new parameter and
statistics into the given tensors (see :mod:`.adamw`)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import (tree_leaves, tree_leaves_up_to, tree_map,
                              tree_unflatten)

from .adamw import scalar

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8           # beta2_t = 1 - step**-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 32


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 32 and p.shape[-2] >= 32


def adafactor_init(params) -> dict:
    def init(p):
        zeros = lambda shape: torch.zeros(shape, dtype=_F32, device=p.device)
        if _factored(p):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}

    leaf = next(iter(tree_leaves(params)))
    return {"stats": tree_map(init, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adafactor_update(cfg: AdafactorConfig, grads, state: dict, params, *,
                     inplace: bool = False):
    """-> (new params, new state {"stats", "step"}, {}).  With ``inplace``
    the new values are written into ``params`` and ``state``'s tensors,
    which are returned."""
    step = state["step"] + 1
    beta2 = 1.0 - step.to(_F32) ** (-cfg.decay)

    def upd(g, s, p):
        g = g.to(_F32)
        g2 = torch.square(g) + cfg.eps
        if _factored(p):
            vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (vr[..., None] / torch.clamp_min(
                vr.mean(dim=-1, keepdim=True)[..., None], cfg.eps)
                * vc[..., None, :])
            update = g * torch.rsqrt(torch.clamp_min(denom, cfg.eps))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            update = g * torch.rsqrt(torch.clamp_min(v, cfg.eps))
            new_s = {"v": v}
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp_min(
            rms / scalar(cfg.clip_threshold, rms), 1.0)
        p32 = p.to(_F32)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p32
        p_new = (p32 - cfg.lr * update).to(p.dtype)
        if inplace:
            for k, t in new_s.items():
                s[k].copy_(t)
            return p.copy_(p_new), s
        return p_new, new_s

    with torch.no_grad():
        out = [upd(g, s, p) for g, s, p in zip(
            tree_leaves(grads), tree_leaves_up_to(grads, state["stats"]),
            tree_leaves(params))]
    if inplace:
        state["step"].copy_(step)
        return params, state, {}
    new_p = tree_unflatten(grads, [o[0] for o in out])
    new_s = tree_unflatten(grads, [o[1] for o in out])
    return new_p, {"stats": new_s, "step": step}, {}
