"""AdamW + cosine schedule + global-norm clipping (functional, nested
dicts of tensors), ``repro``'s update leaf for leaf.

Leaves are walked in ``jax.tree``'s order (dict keys sorted), so the
global norm's fp32 sum adds them in ``repro``'s order.  Where each leaf is
one rank's shard of the gradient (a mesh step), :func:`global_norm` takes
a tree that says how each is split (``launch/sharding.py::LeafSplit``)
and sums the squares over the ranks that split each leaf, a replicated
leaf once.  ``inplace=True`` is the counterpart of donating the state to
``repro``'s jitted step: each leaf's new parameter and moments are
written into the given tensors as soon as they are computed, so the
update never holds a second copy of the parameters or the moments, and
the clipped gradient exists for one leaf at a time."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "clip_by_global_norm", "global_norm"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim fp32 tensor on ``like``'s device: dividing by it is
    a true fp32 division on every device (a Python divisor may become a
    product with its reciprocal on the card)."""
    return torch.full((), x, dtype=_F32, device=like.device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 0 at ``total_steps``; fp32."""
    s = step.to(_F32)
    warm = cfg.lr * s / scalar(max(1, cfg.warmup_steps), s)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / scalar(max(1, cfg.total_steps - cfg.warmup_steps),
                                s), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the fp32 sum of squares of every leaf, the leaves' sums
    added one by one in ``jax.tree`` order.  ``split``: where the leaves
    are one rank's shards, a tree like ``tree`` of objects with ``parts``
    (the ranks that split the leaf, hashable) and ``sum`` (a tensor
    summed over those ranks).  The sums of the leaves split alike are
    added in order, then summed over their ranks (one all-reduce an
    axis), and these added in the order they first appear: a leaf no
    rank splits counts once."""
    leaves = tree_leaves(tree)
    splits = [None] * len(leaves) if split is None else tree_leaves(split)
    sums: dict = {}
    for g, sp in zip(leaves, splits):
        key = () if sp is None else sp.parts
        first, part = sums.get(key, (sp, 0))
        sums[key] = (first, part + torch.sum(torch.square(g.to(_F32))))
    total = 0
    for key, (sp, part) in sums.items():
        total = total + (sp.sum(part) if key else part)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(scalar(max_norm, norm)
                           / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32;
    the global norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(_F32) * scale, grads), norm


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
    leaf = next(iter(tree_leaves(params)))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(cfg: AdamWConfig, grads, state: dict, params, *,
                 inplace: bool = False,
                 grad_norm: torch.Tensor | None = None):
    """-> (new params, new state {"m", "v", "step"}, {"lr", "grad_norm"}).
    With ``inplace`` the new values are written into ``params`` and
    ``state``'s tensors, which are returned.  ``grad_norm`` is the global
    norm that clips the update, where ``grads`` holds one rank's shards of
    the gradient (default: ``grads``' own global norm)."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.clip_norm)
    s = step.to(_F32)
    bc1 = 1 - torch.pow(scalar(cfg.b1, s), s)
    bc2 = 1 - torch.pow(scalar(cfg.b2, s), s)

    def upd(g, m, v, p):
        g = g.to(_F32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        del g
        if inplace:             # the moments' copies go before the rest
            m_new, v_new = m.copy_(m_new), v.copy_(v_new)
        p32 = p.to(_F32)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p_new = (p32 - lr * delta).to(p.dtype)
        if inplace:
            return p.copy_(p_new), m_new, v_new
        return p_new, m_new, v_new

    flat_g = tree_leaves(grads)
    with torch.no_grad():
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(params))]
    if inplace:
        state["step"].copy_(step)
        return params, state, {"lr": lr, "grad_norm": gnorm}
    new_p = tree_unflatten(grads, [o[0] for o in out])
    new_m = tree_unflatten(grads, [o[1] for o in out])
    new_v = tree_unflatten(grads, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "lr": lr, "grad_norm": gnorm}
