"""Pipeline-parallel launch mode: the Synergy inter-frame pipeline at POD
granularity ('PP over pod').

The multi-pod mesh's inter-pod links are the slowest fabric; a GPipe
microbatch pipeline keeps that traffic point-to-point — the same
communication-pattern argument the paper makes for pipelining across
heterogeneous interconnect.  Stages = contiguous layer groups; each pod
holds one stage's parameters; microbatches stream through
``repro_torch.core.pipeline.gpipe_spmd``.

Demonstrated for the dense family (block stacks split evenly across the
stage axis).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import gpipe_spmd
from repro_torch.models.transformer import _attn_block_fwd, _scan_blocks
from repro_torch.tree import tree_map
from .sharding import gather_over

__all__ = ["split_stages", "build_pp_forward"]


def split_stages(params: dict, num_stages: int) -> dict:
    """Reshape the stacked (L, ...) block params to (S, L/S, ...)."""
    return tree_map(
        lambda a: a.reshape((num_stages, a.shape[0] // num_stages)
                            + a.shape[1:]), params["blocks"])


def build_pp_forward(cfg: ArchConfig, mesh, *, stage_axis: str = "pod",
                     microbatches: int = 8):
    """Returns (fn, num_stages): the pipelined backbone forward
    ``fn(staged_blocks, embeds (M, mb, S, d))``, called on every rank of
    ``mesh``, with the stages on its ``stage_axis`` and M ==
    ``microbatches`` (a stream of another length raises).  Each rank runs its
    stage's blocks (``staged_blocks[stage]``); the result is every
    stage's outputs stacked, (S*M, mb, S, d), on every rank (``repro``'s
    ``out_specs=P(stage_axis)``): the last M are the backbone's."""
    num_stages = mesh.shape[mesh.mesh_dim_names.index(stage_axis)]
    assert cfg.n_layers % num_stages == 0
    per_stage = cfg.n_layers // num_stages

    def stage_fn(stage_blocks, x):
        body = lambda p, h: _attn_block_fwd(cfg, p, h)
        return _scan_blocks(body, x, stage_blocks, per_stage)

    def pipelined(staged_blocks, mbs: torch.Tensor) -> torch.Tensor:
        if mbs.shape[0] != microbatches:
            raise ValueError(f"the pipeline was built for {microbatches} "
                             f"microbatches, given {mbs.shape[0]}")
        stage = mesh.get_local_rank(stage_axis)
        my_blocks = tree_map(lambda a: a[stage], staged_blocks)
        out = gpipe_spmd(stage_fn, my_blocks, mbs, mesh=mesh,
                         axis_name=stage_axis, num_stages=num_stages)
        return gather_over(out, (stage_axis,), mesh)

    return pipelined, num_stages
