"""One train step of the port against repro's ``_train_step``, on the
CPU, for one reduced arch per family (dense, moe — which trains with
Adafactor —, ssm, hybrid, vlm, audio), from the same state (repro's,
carried across by ``train_state_from_jax``) and the same batch (each
package's ``make_batch``, bitwise equal).

Tolerances, each relative to the reference leaf's largest entry: loss,
lr and grad norm 1e-5; every gradient leaf 1e-4; the new parameters 1e-5;
the new optimizer moments 2e-4 (AdamW's v and Adafactor's factors are
squares of the gradients, so they carry twice its error)."""


import jax
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import make_batch as j_make_batch
from repro.launch.train import _train_step as j_train_step
from repro.launch.train import default_opt_cfg as j_default_opt_cfg
from repro.launch.train import make_train_state as j_make_train_state
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch
from repro_torch.launch import loss_and_grads
from repro_torch.launch.train import _train_step, default_opt_cfg
from repro_torch.models import train_state_from_jax
from repro_torch.tree import tree_leaves

#: the SSM families (mamba2, zamba2) are in test_torch_train_step_ssm.py,
#: which keeps each file's serial time short
FAMILIES = ["granite-3-2b", "dbrx-132b", "internvl2-1b", "whisper-small"]
CELL = (32, 2)                    # seq_len, global batch
SCALAR_TOL, GRAD_TOL, PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4, 1e-5, 2e-4


def _close(port, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = port.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - ref).max(initial=0.0)) / scale
    assert err <= tol, (err, tol)


def _configs(name):
    kw = {"n_layers": 4} if J_ARCHS[name].family == "hybrid" else {}
    return j_reduced(J_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _repro_run(name):
    """repro's state, gradients, loss, stepped state and metrics."""
    jcfg, _ = _configs(name)
    cell = JShapeCell("t", *CELL, "train")
    jstate = j_make_train_state(jcfg, jax.random.key(0))
    jbatch = j_make_batch(jcfg, cell, seed=0, step=0)

    def run(state, batch):       # one compilation for both
        return (jax.value_and_grad(lambda p: j_loss_fn(jcfg, p, batch))(
            state["params"]),
            j_train_step(jcfg, j_default_opt_cfg(jcfg), state, batch))

    (jloss, jgrads), (new, metrics) = jax.jit(run)(jstate, jbatch)
    return (_np_tree(jstate), _np_tree(jgrads), float(jloss),
            _np_tree(new), {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_repro(name):
    check_step(name)


def check_step(name):
    jstate, jgrads, jloss, jnew, jmetrics = _repro_run(name)
    _, cfg = _configs(name)
    cell = ShapeCell("t", *CELL, "train")
    state = train_state_from_jax(jstate, device="cpu")
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    loss, grads = loss_and_grads(cfg, state["params"], batch)
    assert abs(float(loss) - jloss) <= SCALAR_TOL * abs(jloss)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        _close(g, w, GRAD_TOL)

    new, metrics = _train_step(cfg, default_opt_cfg(cfg), state, batch)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - v) <= SCALAR_TOL * abs(v), k
    assert int(new["step"]) == int(jnew["step"]) == 1
    for p, w in zip(tree_leaves(new["params"]),
                    jax.tree.leaves(jnew["params"])):
        _close(p, w, PARAM_TOL)
    opt, jopt = new["opt"], jnew["opt"]
    assert int(opt["step"]) == int(jopt["step"]) == 1
    moments = {k: v for k, v in opt.items() if k != "step"}
    jmoments = {k: v for k, v in jopt.items() if k != "step"}
    assert sorted(moments) == sorted(jmoments)
    assert len(tree_leaves(moments)) == len(jax.tree.leaves(jmoments))
    for m, w in zip(tree_leaves(moments), jax.tree.leaves(jmoments)):
        _close(m, w, MOMENT_TOL)
