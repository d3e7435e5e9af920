"""FSDP gathered layer by layer, and the MoE decode on the rank's own cache
rows, on gloo ranks on the CPU.

One ``spawn`` (``test_torch_mesh.py``) of 4 gloo ranks runs reduced
internlm2-20b (dense), zamba2-2.7b (hybrid, ``n_layers=4``) and dbrx-132b
(MoE, 16 experts: its decode's expert choice over the 8 rows drops
tokens), each with ``fsdp=True``, on a (data 2, model 1) mesh (the
(data, model) slice of a (2, 2, 1) mesh: ranks 0-1 and 2-3 are two such
meshes) and on a (data 2, model 2) mesh.  Every leaf that the specs
split over 'data' reaches the model code as the rank's shard and is
gathered just before its layer (``gather_for_use``).  Held here:

* the train step bit for bit the same step computed from the tree
  gathered whole over 'data' (``gather_data_tree``, the parent
  computation: gathering is only concatenation, and a sum of two terms
  has one order): the forward's logits, the loss, every gradient shard
  (reduce-scattered here, all-reduced and sliced there), the metrics and
  the stepped state;
* the loss within 1e-5 of repro's single-device ``loss_fn`` on the same
  numpy parameters (``test_multipod_loss_matches_repro``'s tolerance);
* the prefill bit for bit the prefill of the gathered tree, and the
  prefill's and four decode steps' logits and caches against the
  single-process whole-batch steps: bit for bit at a 'model' size of 1,
  within 1e-5 (``test_torch_mesh.py``'s sharded decode) at 2; the MoE
  decode splits its rows and gathers only the MoE's input rows;
* no all-gather a rank issues in a step is larger than the largest
  leaf of one layer, whole over 'data' (recorded from the collectives by
  a dispatch mode);
* ``remat=False`` under autograd with a layer split over 'data' raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import make_train_state as j_make_train_state
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch
from repro_torch.models import (decode_fn, init_cache, lm_params_from_jax,
                                prefill_fn, train_state_from_jax)
from repro_torch.tree import tree_leaves

from test_torch_mesh import _configs, _np, rank_result, spawn

NAMES = ["internlm2-20b", "zamba2-2.7b", "dbrx-132b"]
KW = {"zamba2-2.7b": {"n_layers": 4}, "dbrx-132b": {"n_experts": 16}}
MESHES = ["2x1", "2x2"]
WORLD = 4
CELL = (16, 8)                   # seq_len, global batch
B, S, MAX_LEN, STEPS = 8, 8, 16, 4
LOSS_TOL, SERVE_TOL = 1e-5, 1e-5


def _cfgs(name):
    jcfg, cfg = _configs(name, **KW.get(name, {}))
    return (dataclasses.replace(jcfg, fsdp=True),
            dataclasses.replace(cfg, fsdp=True))


_RANKS = '''
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch
from repro_torch.launch import (build_train_step, gather_tree, make_test_mesh,
                                place_tree)
from repro_torch.launch.serve import build_decode_step, build_prefill_step
from repro_torch.launch.sharding import (axes_of, data_gather_of,
                                         gather_data_tree, gather_over,
                                         leaf_split, local_shard, local_tree,
                                         model_axis_of, without_model)
from repro_torch.launch.train import _mesh_loss_and_grads, default_opt_cfg
from repro_torch.models import lm_forward, prefill_fn
from repro_torch.models.partition import use_data_gather, use_model_axis
from repro_torch.optim import adafactor_update, adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map

cell = ShapeCell("t", *load("cell"), "train")
B, S, MAX_LEN = load("serve")


class Gathers(TorchDispatchMode):
    """The bytes of each all-gather's result, whatever API issued it."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func._overloadpacket)
        if "allgather" in name or "all_gather" in name:
            where = args[0] if name.startswith("c10d.") else out
            self.sizes.append(sum(
                t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves(where)
                if isinstance(t, torch.Tensor)))
        return out


def layer_bytes(cfg, tree, specs, mesh):
    # the largest leaf of one layer (a stacked leaf's slice), whole over
    # the data axes: this rank's 'model' shard
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = 0
    for path, t, s in zip(paths(tree), tree_leaves(tree),
                          tree_leaves(specs)):
        split = 1
        for e in s:
            split *= sizes["model"] if "model" in axes_of(e) else 1
        n = t.numel() * t.element_size() // split
        if path.startswith(("blocks/", "encoder/")):
            n //= t.shape[0]
        out = max(out, n)
    return out


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def whole_gather_step(cfg, mesh, sspecs, bspecs, state, batch):
    # the step from the parameter tree gathered whole over 'data'
    pspecs = sspecs["params"]
    params = gather_data_tree(state["params"], pspecs, mesh)
    loss, grads = _mesh_loss_and_grads(cfg, mesh, bspecs, params, batch)
    shards = tree_map(lambda g, s: local_shard(g, without_model(s), mesh),
                      grads, pspecs)
    split = tree_map(lambda g, s: leaf_split(s, mesh, g.dim()), shards,
                     pspecs)
    opt, mine = local_tree(state["opt"]), local_tree(state["params"])
    if cfg.optimizer == "adafactor":
        _, _, m = adafactor_update(default_opt_cfg(cfg), shards, opt, mine,
                                   inplace=True, split=split)
    else:
        _, _, m = adamw_update(default_opt_cfg(cfg), shards, opt, mine,
                               inplace=True,
                               grad_norm=global_norm(shards, split))
    state["step"].to_local().add_(1)
    return loss, shards, {"loss": loss, **m}


def equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b))) and len(
        tree_leaves(a)) == len(tree_leaves(b))


def train(mesh, cfg, state):
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    fn, (_, sspecs), (_, bspecs) = build_train_step(cfg, cell, mesh)
    pspecs = sspecs["params"]
    mine = {k: local_shard(v, bspecs[k], mesh) for k, v in batch.items()}
    placed = place_tree(tree_map(torch.clone, state), sspecs, mesh)
    shards = local_tree(placed["params"])
    split = sum(1 for s in tree_leaves(pspecs)
                if any(a != "model" for e in s for a in axes_of(e)))
    # the forward, on this rank's rows
    with torch.no_grad(), use_model_axis(model_axis_of(mesh)):
        want_fwd = lm_forward(cfg, gather_data_tree(placed["params"],
                                                    pspecs, mesh),
                              tokens=mine["tokens"])
        with use_data_gather(data_gather_of(pspecs, mesh)):
            got_fwd = lm_forward(cfg, shards, tokens=mine["tokens"])
    loss, grads = _mesh_loss_and_grads(cfg, mesh, bspecs, shards, batch,
                                       pspecs)
    oracle = place_tree(tree_map(torch.clone, state), sspecs, mesh)
    w_loss, w_grads, w_metrics = whole_gather_step(cfg, mesh, sspecs,
                                                   bspecs, oracle, batch)
    with Gathers() as seen:
        new, metrics = fn(placed, batch)
    return {"split_leaves": split,
            "forward": torch.equal(got_fwd, want_fwd),
            "loss": loss, "loss_equal": torch.equal(loss, w_loss),
            "grads": equal(grads, w_grads),
            "metrics": sorted(metrics) == sorted(w_metrics) and all(
                torch.equal(v, w_metrics[k]) for k, v in metrics.items()),
            "state": equal(local_tree(new), local_tree(oracle)),
            "largest_gather": max(seen.sizes),
            "layer_bytes": layer_bytes(cfg, state["params"], pspecs, mesh)}


def refused(mesh, cfg, state):
    cfg = dataclasses.replace(cfg, remat=False)
    fn, (_, sspecs), _ = build_train_step(cfg, cell, mesh)
    try:
        fn(place_tree(tree_map(torch.clone, state), sspecs, mesh),
           make_batch(cfg, cell, seed=0, step=0, device="cpu"))
    except ValueError as e:
        return str(e)
    return None


def serve(mesh, cfg, inp):
    prefill, (_, pspecs), (_, pb) = build_prefill_step(
        cfg, ShapeCell("p", S, B, "prefill"), mesh)
    decode, (_, dspecs), (_, bspecs) = build_decode_step(
        cfg, ShapeCell("d", MAX_LEN, B, "decode"), mesh)
    placed = place_tree(inp["params"], pspecs, mesh)
    with Gathers() as seen:
        logits = prefill(placed, {"tokens": inp["tokens"]})
    gathers = [max(seen.sizes)]
    axes = axes_of(pb["tokens"][0])
    with use_model_axis(model_axis_of(mesh)):
        want = gather_over(prefill_fn(
            cfg, gather_data_tree(placed, pspecs, mesh),
            tokens=local_shard(inp["tokens"], pb["tokens"], mesh)),
            axes, mesh)
    params = place_tree(inp["params"], dspecs, mesh)
    fresh = tree_map(torch.clone, inp["cache"])
    cache = place_tree(fresh, bspecs["cache"], mesh)
    before = [t.to_local().data_ptr() for t in tree_leaves(cache)]
    steps = []
    for i, tok in enumerate(inp["decode"]):
        with Gathers() as seen:
            lg, cache = decode(params, cache, tok, i)
        gathers.append(max(seen.sizes))
        steps.append(lg)
    return {"prefill": logits, "prefill_equal": torch.equal(logits, want),
            "decode": steps, "cache": gather_tree(cache),
            "in_place": before == [t.to_local().data_ptr()
                                   for t in tree_leaves(cache)],
            "largest_gather": max(gathers),
            "layer_bytes": layer_bytes(cfg, inp["params"], dspecs, mesh)}


meshes = {"2x1": init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=(
              "pair", "data", "model"))["data", "model"],
          "2x2": make_test_mesh(data=2, model=2, device_type="cpu")}
out = {}
for key, mesh in meshes.items():
    out[key] = {"coords": {a: mesh.get_local_rank(a)
                           for a in ("data", "model")}}
    for name, kw in load("names"):
        cfg = dataclasses.replace(reduced(ARCHS[name], **kw), fsdp=True)
        state = load("state_" + name)
        out[key][name] = {"train": train(mesh, cfg, state),
                          "serve": serve(mesh, cfg,
                                         load("inputs_" + name))}
        if name == "internlm2-20b":
            out[key][name]["refused"] = refused(mesh, cfg, state)
save("fsdp", out)
'''


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """The ranks' results; repro's train states and the port's
    single-process serving results, per arch."""
    d = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(30)
    refs = {}
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        jstate = _np(jax.jit(lambda k: j_make_train_state(jcfg, k))(
            jax.random.key(0)))
        torch.save(train_state_from_jax(jstate, device="cpu"),
                   d / f"state_{name}.pt")
        params = lm_params_from_jax(_np(jax.jit(
            lambda k: j_init_model(jcfg, k))(jax.random.key(1))),
            device="cpu")
        tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)))
        steps = [torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)))
                 for _ in range(STEPS)]
        cache = init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                           device="cpu")
        torch.save({"params": params, "tokens": tokens, "decode": steps,
                    "cache": cache}, d / f"inputs_{name}.pt")
        logits = prefill_fn(cfg, params, tokens=tokens)
        cache = _clone(cache)
        decoded = []
        for i, tok in enumerate(steps):
            lg, cache = decode_fn(cfg, params, cache, tok, i)
            decoded.append(lg)
        refs[name] = {"jstate": jstate, "prefill": logits,
                      "decode": decoded, "cache": cache}
    torch.save([(n, KW.get(n, {})) for n in NAMES], d / "names.pt")
    torch.save(CELL, d / "cell.pt")
    torch.save((B, S, MAX_LEN), d / "serve.pt")
    spawn(d, WORLD, _RANKS, timeout=240)
    return d, refs


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _results(d, key, name):
    return [rank_result(d, "fsdp", r)[key][name] for r in range(WORLD)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", MESHES)
def test_train_step_is_bitwise_the_whole_gather_step(fsdp_run, key, name):
    """Forward, loss, gradient shards, metrics and the stepped state of
    every rank ``torch.equal`` to the step from the whole-gathered tree;
    the leaves really are split over 'data'."""
    d, _ = fsdp_run
    for res in _results(d, key, name):
        got = res["train"]
        assert got["split_leaves"] > 0
        assert got["forward"] and got["loss_equal"]
        assert got["grads"] and got["metrics"] and got["state"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", MESHES)
def test_fsdp_loss_matches_repro(fsdp_run, key, name):
    d, refs = fsdp_run
    jcfg, cfg = _cfgs(name)
    batch = make_batch(cfg, ShapeCell("t", *CELL, "train"), seed=0, step=0,
                       device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = float(j_loss_fn(jcfg, refs[name]["jstate"]["params"], jbatch))
    for res in _results(d, key, name):
        assert abs(float(res["train"]["loss"]) - want) <= LOSS_TOL


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", MESHES)
def test_serving_steps_match_the_whole_batch(fsdp_run, key, name):
    """The prefill bit for bit the gathered tree's; the prefill's and
    each decode step's logits and the caches against the single-process
    whole-batch steps (the MoE decode with its rows split): bitwise at a
    'model' size of 1, within SERVE_TOL at 2; the caches written in
    place."""
    d, refs = fsdp_run
    ref = refs[name]

    def check(got, want):
        if key == "2x1":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=SERVE_TOL,
                                       atol=SERVE_TOL)

    for res in _results(d, key, name):
        got = res["serve"]
        assert got["prefill_equal"] and got["in_place"]
        check(got["prefill"], ref["prefill"])
        for lg, want in zip(got["decode"], ref["decode"], strict=True):
            check(lg, want)
        for c, w in zip(tree_leaves(got["cache"]), tree_leaves(ref["cache"]),
                        strict=True):
            check(c, w)


@pytest.mark.parametrize("key", MESHES)
def test_no_gather_is_larger_than_a_layers_leaf(fsdp_run, key):
    """The largest all-gather of a train, prefill or decode step stays
    within the largest leaf of one layer whole over 'data': nothing is
    gathered whole over the layers."""
    d, _ = fsdp_run
    for name in NAMES:
        for res in _results(d, key, name):
            for kind in ("train", "serve"):
                got = res[kind]
                assert 0 < got["largest_gather"] <= got["layer_bytes"], (
                    name, kind)


@pytest.mark.parametrize("key", MESHES)
def test_remat_off_with_layers_split_over_data_raises(fsdp_run, key):
    d, _ = fsdp_run
    for res in _results(d, key, "internlm2-20b"):
        msg = res["refused"]
        assert msg is not None and "remat=False" in msg
        assert "blocks/" in msg
