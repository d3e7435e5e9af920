"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment — the memory-sane optimizer for the 132B/1T MoE archs (second-moment
storage drops from O(params) fp32 to O(rows + cols)).  ``repro``'s update
leaf for leaf; ``inplace=True`` writes each leaf's new parameter and
statistics into the given tensors (see :mod:`.adamw`).  Where the leaves
are one rank's shards (a mesh step), ``split`` (a tree that says how each
is split, ``launch/sharding.py::LeafSplit``) makes every mean run over
the whole leaf: the means of ``g²`` over its last two dimensions, of
``vr`` over its rows and the update's RMS."""

from __future__ import annotations

import dataclasses
import math

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


def _mean(t: torch.Tensor, dim=None, *, split=None, of=None,
          keepdim: bool = False) -> torch.Tensor:
    """The mean of ``t`` over the whole leaf's dimensions ``of`` (default
    ``dim``), which are ``t``'s dimensions ``dim`` (None: all of them).
    ``split`` (``t`` is one rank's shard): ``split.ranks(of)`` ranks split
    those dimensions and ``split.sum(x, of)`` sums ``x`` over them.  Where
    no rank splits them, ``torch.mean``'s own bits."""
    dims = tuple(range(t.dim())) if dim is None else (
        (dim,) if isinstance(dim, int) else tuple(dim))
    of = dims if of is None else ((of,) if isinstance(of, int)
                                  else tuple(of))
    ranks = 1 if split is None else split.ranks(of)
    if ranks == 1:
        return (torch.mean(t) if dim is None
                else t.mean(dim=dim, keepdim=keepdim))
    total = split.sum(t.sum(dim=dims, keepdim=keepdim).contiguous(), of)
    count = math.prod(t.shape[d] for d in dims) * ranks
    return total / scalar(count, total)


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
                     inplace: bool = False, split=None):
    """-> (new params, new state {"stats", "step"}, {}).  With ``inplace``
    the new values are written into ``params`` and ``state``'s tensors,
    which are returned.  ``split``: where the leaves are one rank's
    shards (the statistics then are the shards ``opt_pspecs`` gives), a
    tree like ``grads`` of objects with ``ranks`` and ``sum`` (see
    :func:`_mean`)."""
    step = state["step"] + 1
    beta2 = 1.0 - step.to(_F32) ** (-cfg.decay)

    def upd(g, s, p, sp):
        g = g.to(_F32)
        g2 = torch.square(g) + cfg.eps
        if "vr" in s:           # factored by the whole leaf's shape
            vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, split=sp)
            vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, split=sp)
            denom = (vr[..., None] / torch.clamp_min(_mean(
                vr, -1, split=sp, of=g.dim() - 2, keepdim=True)[..., None],
                cfg.eps) * vc[..., None, :])
            update = g * torch.rsqrt(torch.clamp_min(denom, cfg.eps))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            update = g * torch.rsqrt(torch.clamp_min(v, cfg.eps))
            new_s = {"v": v}
        # update clipping (RMS)
        rms = torch.sqrt(_mean(torch.square(update), split=sp) + 1e-30)
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

    flat_g = tree_leaves(grads)
    splits = [None] * len(flat_g) if split is None else tree_leaves(split)
    with torch.no_grad():
        out = [upd(g, s, p, sp) for g, s, p, sp in zip(
            flat_g, tree_leaves_up_to(grads, state["stats"]),
            tree_leaves(params), splits)]
    if inplace:
        state["step"].copy_(step)
        return params, state, {}
    new_p = tree_unflatten(grads, [o[0] for o in out])
    new_s = tree_unflatten(grads, [o[1] for o in out])
    return new_p, {"stats": new_s, "step": step}, {}
