"""The 'model' axis of a mesh, as the model code sees it in a mesh step.

``repro``'s serving and train steps are jitted with shardings, and XLA's
partitioner splits every product over 'model'.  Here a step over a mesh
(``launch/serve.py``, ``launch/train.py``) runs the model functions inside
:func:`use_model_axis`: each parameter leaf that ``param_pspecs`` shards
over 'model' reaches them as this rank's shard, each cache leaf that
``cache_pspecs`` shards over 'model' as this rank's shard, and a function
that meets such a shard computes its part and combines the parts with the
collectives below (Megatron's column- and row-parallel products, the
vocabulary-parallel embedding and head, expert-parallel MoE, the P-sharded
Mamba2 mixer, decode scores summed over the head dim).  A function finds
whether a leaf is sharded from its shape against the config's global
width, so the spec table stays the one place that decides.  Outside such
a scope, or over an axis of one rank, :func:`model_axis` is None and every
model function takes its single-process path, bit for bit.

Gloo and CUDA tensors: two ranks that share one card cannot form an NCCL
group (NCCL refuses two ranks on one device), so they use gloo.  On the
card gloo takes CUDA tensors for all_reduce, all_gather and
all_to_all_single (torch 2.11: ``chip_smoke.py``'s ``mesh_tp`` phase
runs each of them at two ranks), so the helpers call the same
collectives whatever the backend; the compute stays on the card.

Under autograd (the train step) the collectives are
``torch.autograd.Function``s with the same forward bits, Megatron's pair
among them: :func:`copy_to_model` (f: identity forward, the gradient
summed over 'model' backward) marks a replicated tensor where it enters
partitioned compute, and :func:`reduce_from_model` (g: the sum forward,
identity backward) the partial results that replicated compute then
consumes.  :func:`all_gather_dim` takes back this rank's slice of the
gradient, :func:`all_to_all_rows` the inverse all-to-all.  Where autograd
does not record (serving, ``torch.inference_mode``) each is the plain
collective it was.  (``torch.distributed.nn.functional.all_reduce``
all-reduces in its backward too: used as g it multiplies the gradients by
the number of ranks.)

The data-parallel axes: a mesh step also runs the model functions inside
:func:`use_data_gather`.  A parameter leaf that ``param_pspecs`` splits
over a data axis (FSDP: ``cfg.fsdp``) reaches them as this rank's shard,
and the model code gathers each layer's leaves just before the layer uses
them (:func:`gather_for_use`: an all-gather forward, a reduce-scatter of
the gradient backward), as XLA's partitioner gathers the slice of a
``lax.scan``'s layer inside its loop body.  A decode step's batch rows
are split over the data axes; the MoE decode, which routes the whole
batch as one group, gathers the rows of its input and keeps its own
(:func:`gather_rows`, :func:`own_rows`).  Gloo takes CUDA tensors for
``reduce_scatter_tensor`` as for the collectives above (torch 2.11,
``chip_smoke.py``'s ``mesh_fsdp`` phase).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

__all__ = ["ModelAxis", "model_axis", "use_model_axis", "all_reduce_sum",
           "all_gather_dim", "all_to_all_rows", "glu_regroup",
           "copy_to_model", "reduce_from_model", "all_reduce_max",
           "DataGather", "data_gather", "use_data_gather", "gather_for_use",
           "split_over_data", "gather_rows", "own_rows",
           "saved_as_model_slice"]


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's 'model' group: its process group, size and rank."""

    group: object
    size: int
    rank: int


_AXIS: contextvars.ContextVar = contextvars.ContextVar("model_axis",
                                                       default=None)


def model_axis() -> ModelAxis | None:
    """The 'model' axis of the mesh step this code runs in, or None
    (outside a mesh step, or on an axis of one rank)."""
    return _AXIS.get()


@contextlib.contextmanager
def use_model_axis(axis: ModelAxis | None):
    """Run the body as a rank of ``axis`` (None, or an axis of one rank:
    the single-process path)."""
    token = _AXIS.set(axis if axis is not None and axis.size > 1 else None)
    try:
        yield
    finally:
        _AXIS.reset(token)


def _records(t: torch.Tensor) -> bool:
    """True when autograd records an op on ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place where ``t`` is
    contiguous (returned either way).  No gradient: see
    :func:`reduce_from_model`."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of ``group``, a new
    tensor that autograd does not see."""
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(memory_format=torch.contiguous_format),
                              ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.clone(memory_format=torch.contiguous_format),
                              group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _storage_of(t: torch.Tensor) -> tuple:
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            tuple(t.stride()), t.dtype)


def saved_as_model_slice(x: torch.Tensor, axis: ModelAxis):
    """A ``saved_tensors_hooks`` context under which autograd saves
    ``x`` as this rank's 1/|model| slice and unpacks it by an all-gather
    over ``axis`` (no gradient: the unpacked tensor takes the saved one's
    place).  ``x`` must be the same, bit for bit, on every rank of
    ``axis`` (the residual stream between blocks: g's all-reduce leaves
    every rank the same sum), and then the gather gives back its bits.
    The slice runs along dimension 1 (the sequence), along the flattened
    tensor where ``axis.size`` does not divide it; ``x`` is saved whole
    where neither divides.  Every other tensor saved in the context is
    saved as it is.  A rematerialized block's checkpoint saves its input
    under it, so only the slice stays alive until the backward, which
    gathers the input again where it recomputes the block."""
    key, size, group = _storage_of(x), axis.size, axis.group
    if x.dim() >= 2 and x.shape[1] % size == 0:
        dim, n = 1, x.shape[1] // size
    elif x.numel() % size == 0:
        dim, n = None, x.numel() // size
    else:
        return contextlib.nullcontext()
    rank = axis.rank

    def pack(t):
        if _storage_of(t) != key:
            return t
        part = (t.narrow(1, rank * n, n) if dim == 1
                else t.reshape(-1).narrow(0, rank * n, n))
        return part.clone(memory_format=torch.contiguous_format), t.shape

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        part, shape = packed
        return _gather(part, 0 if dim is None else dim, size,
                       group).reshape(shape)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def copy_to_model(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's f: ``t`` (the same on every rank of ``axis``) where it
    enters partitioned compute.  Forward the identity; backward the
    gradient, a part from each rank, summed over 'model'."""
    return _CopyToModel.apply(t, axis.group) if _records(t) else t


def reduce_from_model(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's g: ``t``, this rank's partial result, summed over
    'model' (:func:`all_reduce_sum`'s bits) for replicated compute to
    consume.  Backward the identity: every rank holds the whole
    gradient of the sum."""
    if _records(t):
        return _ReduceFromModel.apply(t, axis.group)
    return all_reduce_sum(t, axis.group)


def _gather(t: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, size, group):
        ctx.dim, ctx.size = dim, size
        ctx.rank = dist.get_rank(group)
        return _gather(t, dim, size, group)

    @staticmethod
    def backward(ctx, grad):
        width = grad.shape[ctx.dim] // ctx.size
        return grad.narrow(ctx.dim, ctx.rank * width, width), None, None, None


def all_gather_dim(t: torch.Tensor, dim: int, size: int,
                   group) -> torch.Tensor:
    """The ``t`` of every rank of ``group`` (``size`` ranks) concatenated
    along ``dim`` in rank order.  Backward: this rank's slice of the
    gradient (the consumers are replicated compute)."""
    if _records(t):
        return _GatherDim.apply(t, dim, size, group)
    return _gather(t, dim, size, group)


def _all_to_all(t: torch.Tensor, in_splits: list, out_splits: list,
                group) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((sum(out_splits), *t.shape[1:]))
    dist.all_to_all_single(out, t, out_splits, in_splits, group=group)
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, in_splits, out_splits, group):
        ctx.splits, ctx.group = (in_splits, out_splits), group
        return _all_to_all(t, in_splits, out_splits, group)

    @staticmethod
    def backward(ctx, grad):
        in_splits, out_splits = ctx.splits
        return (_all_to_all(grad, out_splits, in_splits, ctx.group), None,
                None, None)


def all_to_all_rows(t: torch.Tensor, in_splits: list, out_splits: list,
                    group) -> torch.Tensor:
    """``all_to_all_single`` over the first dimension: ``in_splits[d]``
    rows of ``t`` (in order) go to rank d, and the result holds
    ``out_splits[s]`` rows from each rank s, in rank order.  Backward:
    the inverse all-to-all, the splits swapped."""
    if _records(t):
        return _AllToAllRows.apply(t, in_splits, out_splits, group)
    return _all_to_all(t, in_splits, out_splits, group)


def glu_regroup(blocks: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A GLU input projection's blocks, regrouped for the row-parallel
    output projection.  ``wi`` is ``[gate | up]`` along its last dimension
    and split over 'model' in contiguous blocks, so rank s holds blocks
    2s and 2s + 1 of the 2R blocks of width d_ff / R, while its ``wo``
    rows need block s of ``gate`` and of ``up`` (blocks s and R + s).
    ``blocks`` (2, ...) holds this rank's two blocks (of ``wi``'s columns
    or of the activations they make); returns (2, ...): its ``gate`` and
    ``up`` blocks, by one all-to-all that moves one block to each of two
    ranks."""
    r, size = axis.rank, axis.size
    n = blocks.shape[1] if blocks.dim() > 1 else 1
    dests = [(2 * r) % size, (2 * r + 1) % size]     # block k -> rank k % R
    order = sorted(range(2), key=dests.__getitem__)
    send = blocks if order == [0, 1] else blocks[order]
    srcs = [r // 2, (size + r) // 2]                  # gate first, then up
    rows = send.reshape(2 * n, -1)
    out = all_to_all_rows(rows, [n * dests.count(d) for d in range(size)],
                          [n * srcs.count(s) for s in range(size)],
                          axis.group)
    return out.reshape(blocks.shape)


# ---------------------------------------------------------------------------
# the data-parallel axes: FSDP's gather for use, and the decode's rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataGather:
    """The data-parallel axes of a mesh step, as the model code sees them.

    ``leaves`` maps the path of each parameter leaf that a data axis
    splits (``"embed"``, ``"blocks/attn/wq"``, as ``param_pspecs`` names
    them) to its splits: ``((dim, ((size, group), ...)), ...)``, the axes
    of each dimension minor first, the order :func:`gather_for_use`
    gathers them in.  The dimensions of a stacked leaf (``blocks/``,
    ``encoder/``) are those of one layer's slice.  ``rows`` holds the
    ``(size, group, rank)`` of each axis that splits the batch rows,
    minor first."""

    leaves: dict
    rows: tuple = ()


_DATA: contextvars.ContextVar = contextvars.ContextVar("data_gather",
                                                       default=None)


def data_gather() -> DataGather | None:
    """The data axes of the mesh step this code runs in, or None."""
    return _DATA.get()


@contextlib.contextmanager
def use_data_gather(gather: DataGather | None):
    """Run the body with the data axes ``gather`` (None: nothing is
    split over a data axis, the single-process path)."""
    token = _DATA.set(gather)
    try:
        yield
    finally:
        _DATA.reset(token)


def _reduce_scatter(t: torch.Tensor, dim: int, size: int,
                    group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, each keeping its slice
    of ``dim`` (rank order): :func:`_gather`'s adjoint."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _split_over_data(t: torch.Tensor, splits: tuple) -> torch.Tensor:
    for dim, axes in splits:
        for size, group in axes:
            t = _gather(t, dim, size, group)
    return t


class _GatherForUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, splits):
        ctx.splits = splits
        return _split_over_data(t, splits)

    @staticmethod
    def backward(ctx, grad):
        for dim, axes in reversed(ctx.splits):
            for size, group in reversed(axes):
                grad = _reduce_scatter(grad, dim, size, group)
        return grad, None


def split_over_data(tree, path: str) -> list:
    """The paths under ``path`` in ``tree`` (a leaf or a nested dict)
    whose leaves a data axis splits in the current step."""
    gather = _DATA.get()
    if gather is None:
        return []
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in split_over_data(v, f"{path}/{k}")]
    return [path] if path in gather.leaves else []


def gather_for_use(tree, path: str):
    """``tree`` (a parameter leaf or a nested dict of them, found at
    ``path`` of the parameter tree; one layer's slice for a stacked
    leaf) with every leaf that a data axis splits gathered whole over
    the data axes, its 'model' shard kept: FSDP's gather for use.  The
    identity outside :func:`use_data_gather` and for a leaf no data axis
    splits.  Under autograd the backward reduce-scatters the gradient
    (SUM) over the same axes, so the leaf's gradient comes back as this
    rank's shard, summed over them."""
    gather = _DATA.get()
    if gather is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_for_use(v, f"{path}/{k}") for k, v in tree.items()}
    splits = gather.leaves.get(path)
    if not splits:
        return tree
    if _records(tree):
        return _GatherForUse.apply(tree, splits)
    return _split_over_data(tree, splits)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``'s batch rows (dimension 0) from every rank of the step's
    data axes, in rank order (the major axis first); ``t`` itself where
    no data axis splits the rows.  No gradient."""
    gather = _DATA.get()
    for size, group, _ in (gather.rows if gather is not None else ()):
        t = _gather(t, 0, size, group)
    return t


def own_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``t``, the whole batch's rows: what
    :func:`gather_rows` gathered, undone."""
    gather = _DATA.get()
    index, count = 0, 1
    for size, _, rank in reversed(gather.rows if gather is not None
                                  else ()):
        index, count = index * size + rank, count * size
    if count == 1:
        return t
    n = t.shape[0] // count
    return t.narrow(0, index * n, n)
