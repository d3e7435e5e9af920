"""Serving launchers: the prefill and decode steps over a device mesh.

Each step is called on every rank of the mesh with the whole batch, as
``repro``'s jitted steps are called with global arrays.  The parameters
(and the decode cache) come placed, as DTensors: the caller places them
once, by the specs the builder returns, with ``place_tree``, as
``repro``'s steps take arrays that carry their shardings.

The steps compute partitioned over 'model', as XLA's partitioner splits
``repro``'s jitted steps: each rank gathers every parameter leaf over the
data-parallel axes only (FSDP's gather for use) and keeps its own 'model'
shard, keeps its decode cache as its own shards, and runs its
data-parallel slice of the batch (``input_pspecs``) through the port's
``prefill_fn`` / ``decode_fn`` inside ``use_model_axis``, where the
blocks compute their parts and combine them with all-reduces and narrow
all-to-alls or gathers of activations
(:mod:`repro_torch.models.partition`).  No leaf split over 'model' and
no cache leaf is gathered whole over 'model'.  The logits come back
whole over 'model' from the head and are gathered over the data-parallel
axes, so every rank returns the global logits.  The decode cache stays a
tree of DTensors placed by ``cache_pspecs``: each rank works on its batch
rows of it (all rows where they are not independent: an MoE decode routes
the whole batch as one group, so the rows are gathered over the data
axes) and writes the new entries into its own shards.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import decode_fn, input_specs, param_specs, prefill_fn
from repro_torch.models.transformer import decode_rows_independent
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.models.partition import use_model_axis
from .sharding import (P, axes_of, gather_data, gather_data_tree,
                       gather_over, input_pspecs, local_shard,
                       model_axis_of, param_pspecs, without_model)

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

    def step(params, batch):
        local = gather_data_tree(params, pspecs, mesh)
        mine = {k: local_shard(v, bspecs[k], mesh)
                for k, v in batch.items()}
        with use_model_axis(model_axis_of(mesh)):
            logits = prefill_fn(cfg, local,
                                tokens=mine.get("tokens"),
                                embeds=mine.get("embeds"),
                                enc_embeds=mine.get("enc_embeds"))
        return gather_over(logits, axes, mesh)

    return step, (aval, pspecs), (in_specs, bspecs)


def _keep_shard(t: torch.Tensor, spec: P, keep, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` over the data axes, along every
    dimension but ``keep`` (its 'model' shards are this rank's already)."""
    return local_shard(t, P(*(None if d == keep else e
                              for d, e in enumerate(without_model(spec)))),
                       mesh)


def build_decode_step(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                      donate: bool = True):
    """serve_step for decode cells: one new token, seq_len-deep cache.
    Returns (step, (param specs, pspecs), (input specs, pspecs));
    ``step(params, cache, tokens, pos)``, ``params`` and ``cache`` placed
    by the param and cache pspecs -> (global logits (B, 1, V), the cache
    as DTensors).  With ``donate`` the new entries are written into the
    placed cache's own shards; without, into a copy of it.  Where the
    rows are not independent (``decode_rows_independent``: an MoE decode
    routes the whole batch as one expert-choice group) they are not
    split: every rank decodes the whole batch."""
    aval, pspecs = serve_state_specs(cfg, mesh, mode="decode")
    in_specs = input_specs(cfg, cell)
    bspecs = input_pspecs(cfg, cell, in_specs, mesh)
    cspecs = bspecs["cache"]
    split = decode_rows_independent(cfg)
    axes = _batch_axes(bspecs) if split else ()
    rows_dim = 1 if split else None      # the caches' batch dimension

    def step(params, cache, tokens, pos):
        mine = gather_data_tree(params, pspecs, mesh)
        if not donate:
            cache = tree_map(lambda d: d.clone(), cache)
        local = tree_map(DTensor.to_local, cache)
        # this rank's batch rows of every cache leaf (gathered over the
        # data axes where the rows are not split), its own 'model'
        # shards; decode_fn writes them in place
        rows = tree_map(lambda t, s: gather_data(t, s, mesh, rows_dim),
                        local, cspecs)
        tok = local_shard(tokens, P(axes or None), mesh)
        if torch.is_tensor(pos) and pos.dim() == 1:    # per-slot positions
            pos = local_shard(pos, P(axes or None), mesh)
        with use_model_axis(model_axis_of(mesh)):
            logits, _ = decode_fn(cfg, mine, rows, tok, pos)
        for t, r, s in zip(tree_leaves(local), tree_leaves(rows),
                           tree_leaves(cspecs)):
            if r is not t:
                t.copy_(_keep_shard(r, s, rows_dim, mesh))
        return gather_over(logits, axes, mesh), cache

    return step, (aval, pspecs), (in_specs, bspecs)
