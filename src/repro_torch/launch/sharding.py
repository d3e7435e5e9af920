"""Sharding rules: ArchConfig + mesh -> PartitionSpecs for params, inputs,
caches, optimizer state; and specs -> DTensor placements.

Scheme (``repro``'s rule table, line for line):
  * DP/FSDP over ('pod','data') / 'data'; TP/EP over 'model'.
  * Megatron column/row parallel attention+MLP; vocab-sharded embeddings;
    expert-sharded MoE; P-dim-sharded SSD (see models/ssm.py docstring).
  * Divisibility fallbacks are automatic: an axis is only assigned when it
    divides the dim (so reduced test configs on 2x2 meshes and full configs
    on 16x16 use the same rule table).
  * KV caches shard the HEAD_DIM on 'model' (see :func:`cache_pspecs`).

A :class:`PartitionSpec` is a tuple with one entry per tensor dimension:
an axis name, a tuple of names, or None; dimensions past its end are not
sharded.  :func:`to_placements` turns it into one DTensor placement per
mesh dimension: ``Shard(d)`` for every mesh axis it names on dimension
``d``, ``Replicate()`` for every other axis.  A tuple entry shards the
dimension over all its axes, the first-named the major one, which is the
mesh's own order (``DeviceMesh`` splits a dimension that several mesh
dimensions shard in mesh order).  The rules read each axis's size by name
from a ``DeviceMesh`` (or anything with ``mesh_dim_names`` and
``shape``) and walk the port's nested-dict trees by the leaf paths
``repro`` builds: ``blocks/...``, ``/attn/``, ``/mixer/``, ``shared/...``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.partition import DataGather, ModelAxis, all_gather_dim
from repro_torch.tree import tree_map
from .mesh import MODEL_AXIS, dp_axes

__all__ = ["PartitionSpec", "param_pspecs", "input_pspecs", "opt_pspecs",
           "state_pspecs", "to_placements", "cache_pspecs", "place_tree",
           "gather_tree", "local_shard", "axes_of", "mean_over",
           "gather_over", "model_axis_of", "without_model",
           "gather_data", "gather_data_tree", "LeafSplit", "leaf_split",
           "data_gather_of", "local_tree"]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading tensor
    dimension (an axis name, a tuple of names, or None).  As in JAX, a
    tuple of one name is that name, and an empty one None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, map(norm, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _div(axis: str | tuple, size: int, mesh) -> Any:
    """Return axis spec if it evenly divides `size`, else None."""
    if axis is None:
        return None
    names = (axis,) if isinstance(axis, str) else axis
    total = 1
    for n in names:
        total *= _axis_size(mesh, n)
    return axis if size % total == 0 else None


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dicts; ``path`` joins the keys with
    '/' (``repro``'s ``_path_str`` of a ``jax.tree`` key path)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(cfg: ArchConfig, params_aval, mesh,
                 mode: str = "train") -> Any:
    """PartitionSpec tree matching the params tree.

    mode='decode': attention projections shard only when the KV heads
    divide the mesh — the decode cache is hd-sharded, and head-sharded Q
    against hd-sharded K would all-gather the whole cache (13.7 GB/layer
    on dbrx).  Attention FLOPs are trivial at decode, so replicating those
    projections is the right trade."""
    m = MODEL_AXIS
    fsdp = "data" if cfg.fsdp and "data" in mesh.mesh_dim_names else None
    shard_heads = cfg.n_heads and cfg.n_heads % _axis_size(mesh, m) == 0
    shard_kv = cfg.n_kv_heads and cfg.n_kv_heads % _axis_size(mesh, m) == 0
    if mode == "decode":
        shard_heads = shard_heads and shard_kv

    def spec_for(path: str, v) -> P:
        shape = v.shape
        # strip the stacked-layer leading dim for blocks/encoder stacks
        stacked = (path.startswith("blocks/") or path.startswith("encoder/"))
        inner = shape[1:] if stacked else shape

        def out(*axes):
            axes = [_div(a, d, mesh) if a else None
                    for a, d in zip(axes, inner)]
            return P(*([None] + axes if stacked else axes))

        if path == "embed":
            return P(_div(m, shape[0], mesh), _div(fsdp, shape[1], mesh))
        if path == "lm_head":
            return P(_div(fsdp, shape[0], mesh), _div(m, shape[1], mesh))
        if path in ("final_norm", "enc_norm"):
            return P(None)

        leaf = path.split("/")[-1]
        if "/attn/" in path or "/cross/" in path:
            if leaf == "wq":
                return out(fsdp, m if shard_heads else None)
            if leaf in ("wk", "wv"):
                # kv shards with heads only when kv divides (g==1 archs);
                # otherwise replicated and activations are repeated to Hq.
                return out(fsdp, m if (shard_heads and shard_kv) else None)
            if leaf == "wo":
                return out(m if shard_heads else None, fsdp)
        if "/mlp/" in path:
            if leaf == "wi":
                return out(fsdp, m)
            if leaf == "wo":
                return out(m, fsdp)
        if "/moe/" in path:
            if leaf == "router":
                return out(None, None)
            if leaf == "w1":
                return out(m, fsdp, None)
            if leaf == "w2":
                return out(m, None, fsdp)
        if "/mixer/" in path:
            if leaf in ("wz", "wx"):
                return out(fsdp, None, m)      # (d, H, P): shard P
            if leaf in ("wbc", "wdt"):
                return out(fsdp, None)
            if leaf == "conv_wx":
                return out(None, None, m)
            if leaf == "norm_scale":
                return out(None, m)
            if leaf == "out_proj":
                return out(None, m, fsdp)      # (H, P, d): row-parallel on P
            return out(*([None] * len(inner)))
        # norms / biases / anything else: replicated (beyond leading L)
        return out(*([None] * len(inner)))

    return _map_with_path(spec_for, params_aval)


def cache_pspecs(cfg: ArchConfig, cache_aval, mesh, batch: int) -> Any:
    m = MODEL_AXIS
    dp = dp_axes(mesh)

    def spec_for(path: str, v) -> P:
        shape = v.shape
        if path.endswith(("k", "v", "xk", "xv")):
            # (n_layers, B, Hkv, S, hd): shard HEAD_DIM on model.
            # Sequence-sharding made the per-token cache write a dynamic-
            # position update into a sharded dim — the SPMD partitioner
            # lowers that to a masked SELECT over the FULL cache per layer.
            # hd % 16 == 0 for every assigned arch; the cost is a small
            # per-layer scores psum instead.
            return P(None, _div(dp, shape[1], mesh), None, None,
                     _div(m, shape[4], mesh))
        if path.endswith("ssm"):
            # (L, B, H, P, N): shard P
            return P(None, _div(dp, shape[1], mesh), None,
                     _div(m, shape[3], mesh), None)
        if path.endswith("conv_x"):
            # (L, B, K-1, H, P)
            return P(None, _div(dp, shape[1], mesh), None, None,
                     _div(m, shape[4], mesh))
        if path.endswith("conv_bc"):
            return P(None, _div(dp, shape[1], mesh), None, None)
        return P(*([None] * len(shape)))

    return _map_with_path(spec_for, cache_aval)


def input_pspecs(cfg: ArchConfig, cell: ShapeCell, specs: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    b = cell.global_batch
    out: dict[str, Any] = {}
    for name, v in specs.items():
        if name == "pos":
            out[name] = P()
        elif name == "cache":
            out[name] = cache_pspecs(cfg, v, mesh, b)
        else:
            batch_axis = _div(dp, v.shape[0], mesh)
            out[name] = P(batch_axis, *([None] * (len(v.shape) - 1)))
    return out


def opt_pspecs(param_specs, opt_aval, optimizer: str) -> Any:
    """Optimizer-state specs derived from param specs."""
    if optimizer == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    # adafactor: vr drops last dim's spec, vc drops second-to-last
    def stats_spec(pspec: P, stat: dict) -> dict:
        parts = list(pspec)
        if "vr" in stat:
            return {"vr": P(*parts[:-1]),
                    "vc": P(*(parts[:-2] + parts[-1:]))}
        return {"v": pspec}

    return {"stats": tree_map(stats_spec, param_specs, opt_aval["stats"]),
            "step": P()}


def state_pspecs(cfg: ArchConfig, state_aval, mesh) -> dict:
    pspecs = param_pspecs(cfg, state_aval["params"], mesh)
    return {
        "params": pspecs,
        "opt": opt_pspecs(pspecs, state_aval["opt"], cfg.optimizer),
        "step": P(),
    }


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def _placements(spec: P, mesh) -> tuple:
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(set(idx)):
            raise ValueError(f"{spec}: dimension {dim} names its axes out "
                             f"of the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec} names axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def to_placements(spec_tree, mesh):
    """Each spec of ``spec_tree`` as one placement per mesh dimension
    (``repro``'s ``to_shardings``)."""
    return tree_map(lambda s: _placements(s, mesh), spec_tree)


def place_tree(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors placed by ``spec_tree``.  Every rank
    holds the whole tree and keeps its own shards: nothing is sent.  A
    leaf that no axis of the mesh splits keeps its tensor (placing copies
    nothing on a mesh of one rank); a split leaf keeps a copy of its
    shard.  A leaf that is a DTensor already stays as it is."""
    def place(t, spec):
        if isinstance(t, DTensor):
            return t
        shard = local_shard(t, spec, mesh)
        if shard.shape != t.shape:
            shard = shard.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(shard, mesh, _placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tree_map(place, tree, spec_tree)


def gather_tree(tree):
    """The whole tensors of a tree of DTensors, on every rank (all-gathers
    over the axes each leaf is sharded on).  A plain tensor is refused:
    the tree was not placed."""
    def whole(t):
        if not isinstance(t, DTensor):
            raise TypeError("gather_tree takes a tree placed by place_tree, "
                            f"given a plain {type(t).__name__}")
        return t.full_tensor()
    return tree_map(whole, tree)


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec``: a view
    of ``t``."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        index, count = 0, 1
        for a in axes:              # the first-named axis is the major one
            n = _axis_size(mesh, a)
            index = index * n + mesh.get_local_rank(a)
            count *= n
        if count > 1:
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
    return t


# ---------------------------------------------------------------------------
# collectives over named axes
# ---------------------------------------------------------------------------

def mean_over(t: torch.Tensor, axes: tuple, mesh,
              summed: tuple = ()) -> torch.Tensor:
    """``t``, in place, made the mean of ``t`` over the ranks of ``axes``:
    an all-reduce SUM over each axis's group (gloo has no AVG), then one
    division by their product.  An axis of one rank sums nothing, and
    neither does an axis of ``summed`` (one of ``axes`` that ``t`` was
    summed over already: a reduce-scatter's result), which is counted."""
    count = 1
    for a in axes:
        size = _axis_size(mesh, a)
        if size > 1 and a not in summed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(a))
        count *= size
    return t.div_(torch.full((), count, dtype=t.dtype, device=t.device))


def gather_over(t: torch.Tensor, axes: tuple, mesh,
                dim: int = 0) -> torch.Tensor:
    """The shards of ``t`` along ``dim`` from every rank of ``axes``
    (``axes[0]`` the major one), concatenated: :func:`local_shard`
    undone.  An axis of one rank gathers nothing."""
    for a in reversed(axes):        # the minor axis first
        size = _axis_size(mesh, a)
        if size > 1:
            t = all_gather_dim(t, dim, size, mesh.get_group(a))
    return t


def model_axis_of(mesh) -> ModelAxis:
    """This rank's 'model' axis of ``mesh``, for :func:`use_model_axis`."""
    return ModelAxis(mesh.get_group(MODEL_AXIS),
                     _axis_size(mesh, MODEL_AXIS),
                     mesh.get_local_rank(MODEL_AXIS))


def without_model(spec: P) -> P:
    """``spec`` with the 'model' axis taken out of every entry: the
    layout of a leaf gathered over the data axes alone."""
    def drop(entry):
        axes = tuple(a for a in axes_of(entry) if a != MODEL_AXIS)
        if axes and len(axes) != len(axes_of(entry)):
            raise ValueError(f"{spec}: an entry mixes 'model' with "
                             f"data axes")
        return axes
    return P(*map(drop, spec))


def gather_data(t: torch.Tensor, spec: P, mesh,
                keep: int | None = None) -> torch.Tensor:
    """``t``, one rank's shard under ``spec``, gathered over the data
    axes alone, along every dimension but ``keep``: a dimension split over
    'model' stays this rank's shard."""
    for dim, entry in enumerate(without_model(spec)):
        if dim != keep and entry:
            t = gather_over(t, axes_of(entry), mesh, dim)
    return t


def local_tree(tree):
    """This rank's shards of a tree of DTensors (``to_local``).  A plain
    tensor is refused: the tree was not placed."""
    def mine(t):
        if not isinstance(t, DTensor):
            raise TypeError("a mesh step takes a tree placed by place_tree, "
                            f"given a plain {type(t).__name__}")
        return t.to_local()
    return tree_map(mine, tree)


def gather_data_tree(tree, spec_tree, mesh):
    """Oracle, for tests only: no step calls it.

    :func:`gather_data` of every leaf of a tree of DTensors placed by
    ``spec_tree``: the whole tree gathered over the data axes at once,
    the 'model' shards kept.  The steps gather layer by layer instead
    (:func:`data_gather_of`); this whole gather is the computation the
    tests hold them to, bitwise.  A plain tensor is refused: the tree was
    not placed."""
    return tree_map(lambda t, spec: gather_data(t, spec, mesh),
                    local_tree(tree), spec_tree)


def data_gather_of(pspecs, mesh, rows: tuple = ()) -> DataGather:
    """The data axes of a mesh step, for
    :func:`~repro_torch.models.partition.use_data_gather`: each parameter
    leaf that a data axis of more than one rank splits under ``pspecs``,
    with its dimensions and axes in :func:`gather_data`'s order (the
    minor axis first), and the axes ``rows`` that split the batch rows."""
    leaves = {}

    def note(path: str, spec: P) -> None:
        lead = 1 if path.startswith(("blocks/", "encoder/")) else 0
        splits = []
        for dim, entry in enumerate(without_model(spec)):
            axes = tuple((_axis_size(mesh, a), mesh.get_group(a))
                         for a in reversed(axes_of(entry))
                         if _axis_size(mesh, a) > 1)
            if axes:
                if dim < lead:
                    raise ValueError(f"{path}: {spec} splits the layer "
                                     f"dimension over a data axis")
                splits.append((dim - lead, axes))
        if splits:
            leaves[path] = tuple(splits)

    _map_with_path(note, pspecs)
    return DataGather(leaves, tuple(
        (_axis_size(mesh, a), mesh.get_group(a), mesh.get_local_rank(a))
        for a in reversed(rows) if _axis_size(mesh, a) > 1))


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """How one rank's shard of a leaf is split over a mesh, for the
    optimizers' whole-leaf sums: for each dimension of the leaf, the
    (axis name, process group, ranks) of every axis of more than one
    rank that splits it."""

    dims: tuple

    def _axes(self, of=None) -> list:
        if of is None:
            return list(self.parts)
        return [a for d in ((of,) if isinstance(of, int) else of)
                for a in self.dims[d]]

    @property
    def parts(self) -> tuple:
        """Every axis that splits some dimension, by name."""
        return tuple(sorted({a for d in self.dims for a in d},
                            key=lambda a: a[0]))

    def ranks(self, of=None) -> int:
        """The number of shards of the dimensions ``of`` (None: all)."""
        return math.prod(size for _, _, size in self._axes(of))

    def sum(self, t: torch.Tensor, of=None) -> torch.Tensor:
        """``t``, in place, summed over the axes that split the
        dimensions ``of`` (None: all), one all-reduce an axis."""
        for _, group, _ in self._axes(of):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


def leaf_split(spec: P, mesh, ndim: int) -> LeafSplit:
    """How ``spec`` splits a leaf of ``ndim`` dimensions: for each
    dimension, the axes of more than one rank that split it (the
    optimizers' whole-leaf sums over one rank's shards)."""
    return LeafSplit(tuple(
        tuple((a, mesh.get_group(a), _axis_size(mesh, a))
              for a in axes_of(spec[d] if d < len(spec) else None)
              if _axis_size(mesh, a) > 1)
        for d in range(ndim)))
