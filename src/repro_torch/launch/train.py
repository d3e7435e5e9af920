"""Training driver: the train step (autograd over the parameter leaves,
then AdamW or Adafactor), checkpointing and the fault-tolerance hooks.

``build_train_step`` returns the step; ``train_loop`` is the end-to-end
driver (data pipeline -> step -> optimizer -> checkpoint), which
``run_with_recovery`` supervises.  ``repro`` jits the step with
``jax.value_and_grad``; here autograd records one eager forward and
``torch.autograd.grad`` takes the gradient of every parameter leaf.
``donate=True`` (the default, as in ``repro``) is the counterpart of
``donate_argnums=(0,)``: the step writes the new parameters, optimizer
state and step counter into the state's own tensors, leaf by leaf, and
returns that state; with ``donate=False`` it returns new tensors and
leaves its input untouched.

Over a device mesh (``build_train_step(cfg, cell, mesh)``) the step is
called on every rank with the whole batch, as ``repro``'s jitted step is
called with global arrays.  The state is a tree of DTensors placed by
``state_pspecs``: the caller places it once with ``place_tree``, as
``train_loop`` does, and the step returns it placed.  The step computes
partitioned over 'model', as XLA's partitioner splits ``repro``'s jitted
step: each rank passes its own shards of the parameters and takes the
loss and its gradient on its data-parallel slice of the batch
(``input_pspecs``) inside ``use_model_axis`` and ``use_data_gather``,
where the blocks compute their parts and autograd differentiates the
collectives that join them (:mod:`repro_torch.models.partition`; the loss
is vocabulary-parallel where the head is split).  A leaf that a data axis
splits (FSDP) is gathered layer by layer just before its use and its
gradient reduce-scattered in the backward, so it comes back as the rank's
shard summed over those axes; every other gradient is all-reduced over
the data-parallel axes, and each is divided by their ranks, which gives
the global-batch mean on every rank ('model' ranks took the same slice
and are not averaged).  Each rank updates only its shards of the
parameters and of the optimizer state: AdamW clipped by the global norm of the whole
gradient (the squares of each shard summed over the axes that split its
leaf, a replicated leaf once), Adafactor with its factored statistics in
their ``opt_pspecs`` shards and every mean (of ``g²`` over rows and
columns, of ``vr``, the update's RMS) summed over the axes that split
the dimensions it runs over (:class:`.sharding.LeafSplit`).
No leaf split over 'model' is gathered whole, forwards or backwards, and
the parameter tree is never gathered whole over the data axes.  At
a 'model' size of 1 the step is the single-process step's arithmetic, bit
for bit.  ``mesh=None`` is the single-device step.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import init_model, input_specs, loss_fn
from repro_torch.models.partition import use_data_gather, use_model_axis
from repro_torch.optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                               adafactor_update, adamw_init, adamw_update)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .hlo_analysis import step_phase
from .sharding import (axes_of, data_gather_of, gather_tree, input_pspecs,
                       leaf_split, local_shard, local_tree, mean_over,
                       model_axis_of, place_tree, state_pspecs, without_model)

__all__ = ["make_train_state", "build_train_step", "train_loop",
           "train_state_specs", "default_opt_cfg", "loss_and_grads"]


def make_train_state(cfg: ArchConfig, key: int | torch.Generator = 0,
                     opt_cfg=None, *,
                     device: str | torch.device | None = None) -> dict:
    """{"params", "opt", "step"} on ``device`` (default the card); on
    ``meta`` stand-ins that allocate nothing."""
    params = init_model(cfg, key, device=device)
    if cfg.optimizer == "adafactor":
        opt = adafactor_init(params)
    else:
        opt = adamw_init(params)
    return {"params": params, "opt": opt, "step": torch.zeros_like(
        opt["step"])}


def train_state_specs(cfg: ArchConfig, mesh=None):
    """(the train state on ``meta``, its partition specs over ``mesh``;
    None without a mesh)."""
    aval = make_train_state(cfg, 0, device="meta")
    return aval, None if mesh is None else state_pspecs(cfg, aval, mesh)


def loss_and_grads(cfg: ArchConfig, params: dict, batch: dict, *,
                   impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """(``lm_loss``, its gradient for every leaf of ``params``, as a tree
    like ``params``); a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it."""
    flat = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, live), batch, impl=impl)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _train_step(cfg: ArchConfig, opt_cfg, state: dict, batch: dict, *,
                donate: bool = True):
    loss, grads = loss_and_grads(cfg, state["params"], batch)
    update = (adafactor_update if cfg.optimizer == "adafactor"
              else adamw_update)
    with step_phase("optimizer"):
        new_params, new_opt, metrics = update(
            opt_cfg, grads, state["opt"], state["params"], inplace=donate)
    if donate:
        state["step"].add_(1)
        return state, {"loss": loss, **metrics}
    new_state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
    return new_state, {"loss": loss, **metrics}


def default_opt_cfg(cfg: ArchConfig):
    return (AdafactorConfig() if cfg.optimizer == "adafactor"
            else AdamWConfig())


def _mesh_loss_and_grads(cfg: ArchConfig, mesh, bspecs: dict, params: dict,
                        batch: dict, pspecs=None) -> tuple[torch.Tensor, dict]:
    """:func:`loss_and_grads` of ``params`` on this rank's slice of the
    global ``batch`` (split by ``bspecs``), computed partitioned over
    'model' and averaged over the data-parallel axes: the global batch's
    loss, and this rank's shards of its gradient, on every rank.
    With ``pspecs`` (how :func:`_mesh_train_step` calls it) the leaves
    are this rank's shards under ``pspecs``, each gathered over the data
    axes for its use and its gradient reduce-scattered back.  Without
    them the leaves are this rank's 'model' shards whole over the data
    axes: that form is an oracle for tests only (the whole-gather step
    the layer-by-layer gathers are held to, bitwise); no step calls it."""
    mine = {k: local_shard(v, bspecs[k], mesh) for k, v in batch.items()}
    axes = axes_of(bspecs["labels"][0])
    gather = None if pspecs is None else data_gather_of(pspecs, mesh)
    with use_model_axis(model_axis_of(mesh)), use_data_gather(gather):
        loss, grads = loss_and_grads(cfg, params, mine)
    # a gradient reduce-scattered over a leaf's data axes is summed over
    # them already; each is counted in the mean, a batch axis or not
    summed = (tree_map(lambda g: (), grads) if pspecs is None
              else tree_map(lambda s: tuple(a for e in without_model(s)
                                            for a in axes_of(e)), pspecs))
    return (mean_over(loss, axes, mesh),
            tree_map(lambda g, s: mean_over(
                g, axes + tuple(a for a in s if a not in axes), mesh,
                summed=s), grads, summed))


def _mesh_train_step(cfg: ArchConfig, opt_cfg, mesh, sspecs: dict,
                     bspecs: dict, state: dict, batch: dict, *,
                     donate: bool = True):
    if not donate:
        state = tree_map(lambda d: d.clone(), state)
    pspecs = sspecs["params"]
    params = local_tree(state["params"])
    loss, shards = _mesh_loss_and_grads(cfg, mesh, bspecs, params, batch,
                                        pspecs)
    split = tree_map(lambda g, s: leaf_split(s, mesh, g.dim()), shards,
                     pspecs)
    with step_phase("optimizer"):
        if cfg.optimizer == "adafactor":
            _, _, metrics = adafactor_update(
                opt_cfg, shards, local_tree(state["opt"]), params,
                inplace=True, split=split)
        else:
            _, _, metrics = adamw_update(
                opt_cfg, shards, local_tree(state["opt"]), params,
                inplace=True, grad_norm=global_norm(shards, split))
    state["step"].to_local().add_(1)
    return state, {"loss": loss, **metrics}


def build_train_step(cfg: ArchConfig, cell: ShapeCell, mesh=None, *,
                     opt_cfg=None, donate: bool = True):
    """Returns (step_fn, (state specs, their pspecs), (batch specs, their
    pspecs)): ``step_fn(state, batch) -> (state, metrics)``; the specs
    are ``meta`` stand-ins, and the pspecs None without a mesh.  Over a
    mesh the state goes in and comes out a tree of DTensors placed by
    the state pspecs."""
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    aval, sspecs = train_state_specs(cfg, mesh)
    in_specs = input_specs(cfg, cell)
    if mesh is None:
        fn = functools.partial(_train_step, cfg, opt_cfg, donate=donate)
        return fn, (aval, None), (in_specs, None)
    bspecs = input_pspecs(cfg, cell, in_specs, mesh)
    fn = functools.partial(_mesh_train_step, cfg, opt_cfg, mesh, sspecs,
                           bspecs, donate=donate)
    return fn, (aval, sspecs), (in_specs, bspecs)


def train_loop(cfg: ArchConfig, mesh=None, *, steps: int, batch_iter,
               cell: ShapeCell, key: int | torch.Generator | None = None,
               state=None, opt_cfg=None, checkpointer=None,
               ckpt_every: int = 0, on_step: Callable | None = None,
               device: str | torch.device | None = None):
    """End-to-end loop: init (or resume from ``state``), step,
    checkpoint, report.  A new state is made on ``device`` (default the
    card; over a mesh, the mesh's device type) from ``key`` (default 0).
    Over a mesh every rank runs the loop, the state is placed by the
    step's specs, and global rank 0 saves the gathered state."""
    fn, (_, sspecs), _ = build_train_step(cfg, cell, mesh, opt_cfg=opt_cfg)
    if state is None:
        if device is None and mesh is not None:
            device = mesh.device_type
        state = make_train_state(cfg, 0 if key is None else key,
                                 device=device)
    if mesh is not None:
        state = place_tree(state, sspecs, mesh)
    history = []
    for _ in range(steps):
        batch = next(batch_iter)
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append(metrics)
        step = int(state["step"] if mesh is None
                   else state["step"].full_tensor())
        if checkpointer is not None and ckpt_every and step % ckpt_every == 0:
            whole = state if mesh is None else gather_tree(state)
            if mesh is None or dist.get_rank() == 0:
                checkpointer.save(step, whole)
        if on_step is not None:
            on_step(step, metrics)
    return state, history
