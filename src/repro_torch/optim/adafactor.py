"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment — the memory-sane optimizer for the 132B/1T MoE archs (second-moment
storage drops from O(params) fp32 to O(rows + cols)).  ``repro``'s update
leaf for leaf; ``inplace=True`` writes each leaf's new parameter and
statistics into the given tensors (see :mod:`.adamw`).  Where the leaves
are one rank's shards (a mesh step), ``split`` (a tree that says how each
is split, ``launch/sharding.py::LeafSplit``) makes every mean run over
the whole leaf: the means of ``g²`` over its last two dimensions, of
``vr`` over its rows and the update's RMS.

A stacked leaf (one with dimensions before its last two: the (L, ...)
layers) is updated one slice of its first dimension at a time, of its
first two where one slice would still hold more than :data:`SLICE_BYTES`
of fp32, and so on: the fp32 temporaries are one slice's, never the whole
leaf's.  Each element's arithmetic is ``repro``'s.  Only the update's
RMS, a mean over the whole leaf, is taken as the sum of the slices' sums
of squares, so the update is computed twice: once for its RMS, once to
clip and write it.  With ``split`` the slices' partial sums are stacked,
then summed over the ranks once per leaf and per mean, as for a leaf
taken whole.  A leaf of one slice keeps the whole-leaf arithmetic."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import (tree_leaves, tree_leaves_up_to, tree_map,
                              tree_unflatten)

from .adamw import scalar

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update"]

_F32 = torch.float32
#: the most fp32 bytes that one slice of a stacked leaf may hold
SLICE_BYTES = 1 << 30


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


def _slices(shape) -> list:
    """The index tuples of a leaf's slices over its dimensions before the
    last two: the first dimension's, finer while one slice would hold
    more than :data:`SLICE_BYTES` of fp32; ``[()]`` (the whole leaf)
    where it has no such dimension."""
    index, d = [()], 0
    while d < len(shape) - 2:
        index = [i + (j,) for i in index for j in range(shape[d])]
        d += 1
        if math.prod(shape[d:]) * 4 <= SLICE_BYTES:
            break
    return index


def _ranks(split, of) -> int:
    return 1 if split is None else split.ranks(of)


def _joined(parts: list, lead: tuple, split, of, count: int) -> torch.Tensor:
    """The slices' means over the dimension ``of`` (their sums, of
    ``count`` entries each, where ranks split it) stacked to the leading
    shape ``lead``: :func:`_mean` of the whole leaf, with one collective
    an axis."""
    stacked = torch.stack(parts).reshape(*lead, *parts[0].shape)
    ranks = _ranks(split, of)
    if ranks == 1:
        return stacked
    total = split.sum(stacked, of)
    return total / scalar(count * ranks, total)


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
        index = _slices(g.shape)
        whole = len(index) == 1
        lead = tuple(g.shape[:len(index[0])])
        if "vr" in s:           # factored by the whole leaf's shape
            if whole:
                g2 = torch.square(g.to(_F32)) + cfg.eps
                rows, cols = _mean(g2, -1, split=sp), _mean(g2, -2, split=sp)
                del g2
            else:               # one slice's g² at a time
                summed = (_ranks(sp, -1) > 1, _ranks(sp, -2) > 1)
                rows, cols = [], []
                for i in index:
                    g2 = torch.square(g[i].to(_F32)).add_(cfg.eps)
                    rows.append(g2.sum(-1) if summed[0] else g2.mean(-1))
                    cols.append(g2.sum(-2) if summed[1] else g2.mean(-2))
                    del g2
                rows = _joined(rows, lead, sp, -1, g.shape[-1])
                cols = _joined(cols, lead, sp, -2, g.shape[-2])
            vr = beta2 * s["vr"] + (1 - beta2) * rows
            vc = beta2 * s["vc"] + (1 - beta2) * cols
            norm = torch.clamp_min(_mean(
                vr, -1, split=sp, of=g.dim() - 2, keepdim=True)[..., None],
                cfg.eps)
            new_s = {"vr": vr, "vc": vc}

            def update_of(i, first):
                denom = vr[i][..., None] / norm[i] * vc[i][..., None, :]
                return denom.clamp_min_(cfg.eps).rsqrt_().mul_(g[i])
        else:
            v = s["v"] if inplace else torch.empty_like(s["v"])
            new_s = {"v": v}

            def update_of(i, first):
                g32 = g[i].to(_F32)
                if first:       # the slice's new second moment
                    v[i].copy_(beta2 * s["v"][i]
                               + (1 - beta2) * (torch.square(g32) + cfg.eps))
                return torch.clamp_min(v[i], cfg.eps).rsqrt_().mul_(g32)
        # update clipping (RMS), the first pass over the slices
        if whole:
            update = update_of((), True)
            rms = torch.sqrt(_mean(torch.square(update), split=sp) + 1e-30)
        else:
            dims = tuple(range(g.dim()))
            total = torch.stack([update_of(i, True).square_().sum()
                                 for i in index]).sum()
            if _ranks(sp, dims) > 1:
                total = sp.sum(total, dims)
            rms = torch.sqrt(total / scalar(g.numel() * _ranks(sp, dims),
                                            total) + 1e-30)
        clip = torch.clamp_min(rms / scalar(cfg.clip_threshold, rms), 1.0)
        out = p if inplace else torch.empty_like(p)
        for i in index:         # the second: clip, decay and write
            u = (update if whole else update_of(i, False)).div_(clip)
            p32 = p[i].to(_F32)
            if cfg.weight_decay:
                u = u.add_(cfg.weight_decay * p32)
            out[i].copy_((p32 - u.mul_(cfg.lr)).to(p.dtype))
            del u, p32
        if inplace and "vr" in s:
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        return out, (s if inplace else new_s)

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
