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
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

__all__ = ["ModelAxis", "model_axis", "use_model_axis", "all_reduce_sum",
           "all_gather_dim", "all_to_all_rows", "glu_regroup",
           "copy_to_model", "reduce_from_model", "all_reduce_max"]


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
