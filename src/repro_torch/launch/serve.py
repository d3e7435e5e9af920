"""Serving launchers: the prefill and decode steps over a device mesh.

Each step is called on every rank of the mesh with the whole batch, as
``repro``'s jitted steps are called with global arrays.  The parameters
(and the decode cache) come placed, as DTensors: the caller places them
once, by the specs the builder returns, with ``place_tree``, as
``repro``'s steps take arrays that carry their shardings.

The steps compute partitioned over 'model', as XLA's partitioner splits
``repro``'s jitted steps: each rank passes its own shards of the
parameters and of the decode cache to the port's ``prefill_fn`` /
``decode_fn`` with its data-parallel slice of the batch
(``input_pspecs``), inside ``use_model_axis`` and ``use_data_gather``.
There the blocks compute their parts over 'model' and combine them with
all-reduces and narrow all-to-alls or gathers of activations, and each
layer's leaves that a data axis splits (FSDP) are gathered over the data
axes just before the layer, its 'model' shard kept
(:mod:`repro_torch.models.partition`).  No leaf and no cache leaf is
gathered whole over 'model', no cache leaf over the data axes, and the
parameter tree is never gathered whole over the data axes at once.  The
logits come back whole over 'model' from the head and are gathered over
the data-parallel axes, so every rank returns the global logits.  The
decode cache stays a tree of DTensors placed by ``cache_pspecs``: each
rank decodes its own batch rows of it and writes the new entries into
its own shards; an MoE decode, which routes the whole batch as one
expert-choice group, gathers the rows of the MoE's input and keeps its
own rows of the output.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import decode_fn, input_specs, param_specs, prefill_fn
from repro_torch.tree import tree_map
from repro_torch.models.partition import use_data_gather, use_model_axis
from .sharding import (P, axes_of, data_gather_of, gather_over,
                       input_pspecs, local_shard, local_tree, model_axis_of,
                       param_pspecs)

__all__ = ["build_prefill_step", "build_decode_step", "serve_state_specs"]


def serve_state_specs(cfg: ArchConfig, mesh, mode: str = "train"):
    aval = param_specs(cfg)
    return aval, param_pspecs(cfg, aval, mesh, mode=mode)


def _batch_axes(bspecs: dict) -> tuple[str, ...]:
    """The axes the batch dimension is split over (none when they do not
    divide it)."""
    name = "tokens" if "tokens" in bspecs else "embeds"
    return axes_of(bspecs[name][0])


def build_prefill_step(cfg: ArchConfig, cell: ShapeCell, mesh):
    """Returns (step, (param specs on meta, their pspecs), (input specs,
    their pspecs)); ``step(params, batch)``, ``params`` placed by the
    param pspecs -> the global last-token logits (B, 1, V) on every
    rank."""
    aval, pspecs = serve_state_specs(cfg, mesh)
    in_specs = input_specs(cfg, cell)
    bspecs = input_pspecs(cfg, cell, in_specs, mesh)
    axes = _batch_axes(bspecs)
    gather = data_gather_of(pspecs, mesh, axes)

    def step(params, batch):
        local = local_tree(params)
        mine = {k: local_shard(v, bspecs[k], mesh)
                for k, v in batch.items()}
        with use_model_axis(model_axis_of(mesh)), use_data_gather(gather):
            logits = prefill_fn(cfg, local,
                                tokens=mine.get("tokens"),
                                embeds=mine.get("embeds"),
                                enc_embeds=mine.get("enc_embeds"))
        return gather_over(logits, axes, mesh)

    return step, (aval, pspecs), (in_specs, bspecs)


def build_decode_step(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                      donate: bool = True):
    """serve_step for decode cells: one new token, seq_len-deep cache.
    Returns (step, (param specs, pspecs), (input specs, pspecs));
    ``step(params, cache, tokens, pos)``, ``params`` and ``cache`` placed
    by the param and cache pspecs -> (global logits (B, 1, V), the cache
    as DTensors).  With ``donate`` the new entries are written into the
    placed cache's own shards; without, into a copy of it.  Each rank
    decodes its rows of the batch, the rows ``cache_pspecs`` gives it,
    for every family."""
    aval, pspecs = serve_state_specs(cfg, mesh, mode="decode")
    in_specs = input_specs(cfg, cell)
    bspecs = input_pspecs(cfg, cell, in_specs, mesh)
    axes = _batch_axes(bspecs)
    gather = data_gather_of(pspecs, mesh, axes)

    def step(params, cache, tokens, pos):
        mine = local_tree(params)
        if not donate:
            cache = tree_map(lambda d: d.clone(), cache)
        # this rank's batch rows of every cache leaf, its own 'model'
        # shards; decode_fn writes them in place
        rows = local_tree(cache)
        tok = local_shard(tokens, P(axes or None), mesh)
        if torch.is_tensor(pos) and pos.dim() == 1:    # per-slot positions
            pos = local_shard(pos, P(axes or None), mesh)
        with use_model_axis(model_axis_of(mesh)), use_data_gather(gather):
            logits, _ = decode_fn(cfg, mine, rows, tok, pos)
        return gather_over(logits, axes, mesh), cache

    return step, (aval, pspecs), (in_specs, bspecs)
