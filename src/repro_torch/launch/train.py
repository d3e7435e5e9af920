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
leaves its input untouched.  A device mesh is not ported yet: ``mesh``
must be None.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import init_model, input_specs, loss_fn
from repro_torch.optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                               adafactor_update, adamw_init, adamw_update)
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["make_train_state", "build_train_step", "train_loop",
           "train_state_specs", "default_opt_cfg", "loss_and_grads"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP.md, "
            "Queue 1 item 4: launch/mesh.py and launch/sharding.py); pass "
            "mesh=None")


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
    """(the train state on ``meta``, its partition specs): the specs come
    with the mesh, so they are None."""
    _no_mesh(mesh)
    return make_train_state(cfg, 0, device="meta"), None


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


def build_train_step(cfg: ArchConfig, cell: ShapeCell, mesh=None, *,
                     opt_cfg=None, donate: bool = True):
    """Returns (step_fn, (state specs, None), (batch specs, None)):
    ``step_fn(state, batch) -> (state, metrics)``; the specs are ``meta``
    stand-ins and the Nones the partition specs that come with the
    mesh."""
    _no_mesh(mesh)
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    aval, sspecs = train_state_specs(cfg)
    fn = functools.partial(_train_step, cfg, opt_cfg, donate=donate)
    return fn, (aval, sspecs), (input_specs(cfg, cell), None)


def train_loop(cfg: ArchConfig, mesh=None, *, steps: int, batch_iter,
               cell: ShapeCell, key: int | torch.Generator | None = None,
               state=None, opt_cfg=None, checkpointer=None,
               ckpt_every: int = 0, on_step: Callable | None = None,
               device: str | torch.device | None = None):
    """End-to-end loop: init (or resume from ``state``), step,
    checkpoint, report.  A new state is made on ``device`` (default the
    card) from ``key`` (default 0)."""
    fn, _, _ = build_train_step(cfg, cell, mesh, opt_cfg=opt_cfg)
    if state is None:
        state = make_train_state(cfg, 0 if key is None else key,
                                 device=device)
    history = []
    for _ in range(steps):
        batch = next(batch_iter)
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append(metrics)
        step = int(state["step"])
        if checkpointer is not None and ckpt_every and step % ckpt_every == 0:
            checkpointer.save(step, state)
        if on_step is not None:
            on_step(step, metrics)
    return state, history
