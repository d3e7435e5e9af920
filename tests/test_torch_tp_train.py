"""The train step computed partitioned over 'model', on gloo ranks on the
CPU, against the port's single-process step and against repro.

One ``spawn`` (``test_torch_mesh.py``) of 4 gloo ranks runs, from repro's
train state carried across (``train_state_from_jax``), one train step on a
(data 2, model 2) and on a (data 1, model 4) mesh for reduced granite-3-2b
(tied embeddings), zamba2-2.7b (hybrid, ``n_layers=4``: P 16, 4 a rank on
the second mesh), dbrx-132b with 16 experts (MoE, Adafactor),
internvl2-1b (GQA: 4 q-heads on 2 kv heads, whole on the second mesh)
and whisper-small (encoder, cross attention), 16 tokens x 8 rows.  Held
here:

* the loss within 1e-5 of the port's single-process ``loss_and_grads``
  and of repro's ``loss_fn``;
* every leaf's gradient shard within 1e-5 of the leaf's largest entry,
  against its slice of the single-process gradient (a replicated leaf
  that feeds partitioned compute holds only a part of its gradient on
  each rank until the parts are summed: a missing sum shows here);
* ``grad_norm`` within 1e-5, the state after the step within 1e-4 of each
  leaf's largest entry (test_torch_train_step.py's criterion), every
  rank's shards against their slices, and every rank reporting the same
  metrics bit for bit;
* at (data 4, model 1) the step bit for bit the arithmetic it had before
  it was partitioned: the whole parameters' loss and gradient on the
  rank's rows, averaged over 'data', then the optimizer on whole leaves;
* the gradient taken on a thread that never entered ``use_model_axis``
  (autograd runs a CUDA backward on a thread of its own) bit for bit the
  one taken on the forward's thread: the rematerialized blocks recompute
  under the forward's 'model' axis;
* no step gathers a 'model'-split leaf whole: the bytes of every
  all-gather a rank issues in the step (``c10d`` and functional, counted
  by a dispatch mode) stay below the whole bytes of those leaves;
* each rematerialized block's input is saved as the rank's 'model'
  slice: the stream is the same bit for bit on every 'model' rank, and
  the loss, gradients, metrics and stepped state are ``torch.equal`` to
  the step that saves the inputs whole (rebuilt in the rank script).

The collectives' own backward passes (f, g, ``all_gather_dim``,
``all_to_all_rows`` and ``glu_regroup``) and the vocabulary-parallel loss
are held on their own at 2 and 4 ranks against single-process gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import make_train_state as j_make_train_state
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch
from repro_torch.launch.sharding import local_shard, state_pspecs
from repro_torch.launch.train import (_train_step, default_opt_cfg,
                                      loss_and_grads, train_state_specs)
from repro_torch.models import train_state_from_jax
from repro_torch.tree import tree_leaves

from test_torch_mesh import _configs, _np, rank_result, spawn

NAMES = ["granite-3-2b", "zamba2-2.7b", "dbrx-132b", "internvl2-1b",
         "whisper-small"]
KW = {"dbrx-132b": {"n_experts": 16}}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
CELL = (16, 8)                   # seq_len, global batch
LOSS_TOL, GRAD_TOL, STATE_TOL = 1e-5, 1e-5, 1e-4


def _cfgs(name):
    return _configs(name, **KW.get(name, {}))


def _kw(name):
    return {**({"n_layers": 4} if name == "zamba2-2.7b" else {}),
            **KW.get(name, {})}


_RANKS = '''
import contextlib
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch
from repro_torch.launch import build_train_step, make_test_mesh, place_tree
from repro_torch.launch.sharding import (axes_of, gather_data_tree,
                                         local_shard, mean_over)
from repro_torch.launch.train import (_mesh_loss_and_grads, default_opt_cfg,
                                      loss_and_grads)
import threading
from repro_torch.launch.sharding import model_axis_of
from repro_torch.models import loss_fn, transformer
from repro_torch.models.layers import softmax_xent
from repro_torch.models.partition import (ModelAxis, all_gather_dim,
                                          all_to_all_rows, copy_to_model,
                                          glu_regroup, reduce_from_model,
                                          use_model_axis)
from repro_torch.optim import adafactor_update, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

cell = ShapeCell("t", *load("cell"), "train")
GATHERS = ("allgather", "all_gather")


class Gathered(TorchDispatchMode):
    """The bytes of every all-gather's result, whatever API issued it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func._overloadpacket)
        if any(g in name for g in GATHERS):
            where = args[0] if name.startswith("c10d.") else out
            self.bytes += sum(t.numel() * t.element_size()
                              for t in torch.utils._pytree.tree_leaves(where)
                              if isinstance(t, torch.Tensor))
        return out


def split_bytes(tree, specs):
    # whole bytes of the leaves split over 'model'
    return sum(t.numel() * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(specs))
               if any("model" in axes_of(e) for e in s))


@contextlib.contextmanager
def saved_inputs(record=None):
    """Each rematerialized block's input recorded (``record``, a list),
    or, with None, saved whole: the step before its saved inputs were
    'model' slices (``_saved_input`` then keeps the whole input, as the
    parent's ``_scan_blocks`` did)."""
    saved = transformer._saved_input

    def recording(x, axis):
        if axis is not None:
            record.append(x.detach().clone())
        return saved(x, axis)

    transformer._saved_input = (
        recording if record is not None
        else lambda x, axis: contextlib.nullcontext())
    try:
        yield
    finally:
        transformer._saved_input = saved


def same_on_model_ranks(mesh, tensors):
    # every recorded stream bit for bit the same on every 'model' rank
    group, size = mesh.get_group("model"), mesh.size(1)
    for t in tensors:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        if not all(torch.equal(p, t) for p in parts):
            return False
    return True


def equal(a, b):
    return len(tree_leaves(a)) == len(tree_leaves(b)) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run(mesh, cfg, state):
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    fn, (_, sspecs), (_, bspecs) = build_train_step(cfg, cell, mesh)
    placed = place_tree(tree_map(torch.clone, state), sspecs, mesh)
    params = gather_data_tree(placed["params"], sspecs["params"], mesh)
    loss, grads = _mesh_loss_and_grads(cfg, mesh, bspecs, params, batch)
    # the same with every block input saved whole (before the step
    # below writes the parameters that ``params`` may share)
    with saved_inputs():
        w_loss, w_grads = _mesh_loss_and_grads(cfg, mesh, bspecs, params,
                                               batch)
    streams = []
    with Gathered() as seen, saved_inputs(streams):
        new, metrics = fn(placed, batch)
    local = tree_map(lambda d: d.to_local().clone(), new)
    with saved_inputs():
        w_new, w_metrics = fn(place_tree(tree_map(torch.clone, state),
                                         sspecs, mesh), batch)
    return {"loss": loss, "grads": grads, "metrics": metrics,
            "local": local, "gathered": seen.bytes,
            "split": split_bytes(state["params"], sspecs["params"]),
            "slices": {"saved": len(streams),
                       "stream": same_on_model_ranks(mesh, streams),
                       "loss": torch.equal(loss, w_loss),
                       "grads": equal(grads, w_grads),
                       "metrics": sorted(metrics) == sorted(w_metrics) and all(
                           torch.equal(v, w_metrics[k])
                           for k, v in metrics.items()),
                       "state": equal(local, tree_map(
                           lambda d: d.to_local(), w_new))}}


def other_thread(mesh, cfg, state):
    """The partitioned loss's gradient taken on a thread that never
    entered ``use_model_axis`` (autograd runs a CUDA backward on a
    thread of its own), against the same forward's gradient taken here:
    the rematerialized blocks must recompute under the forward's axis."""
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    _, (_, sspecs), (_, bspecs) = build_train_step(cfg, cell, mesh)
    placed = place_tree(tree_map(torch.clone, state), sspecs, mesh)
    params = gather_data_tree(placed["params"], sspecs["params"], mesh)
    mine = {k: local_shard(v, bspecs[k], mesh) for k, v in batch.items()}
    grads = []
    for threaded in (False, True):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with use_model_axis(model_axis_of(mesh)), torch.enable_grad():
            loss = loss_fn(cfg, tree_unflatten(params, live), mine)
        box = {}

        def backward():
            try:
                box["grads"] = torch.autograd.grad(loss, live,
                                                   allow_unused=True)
            except Exception as e:      # reported below, on this rank
                box["error"] = repr(e)

        if threaded:
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        else:
            backward()
        if "error" in box:
            return box["error"]
        grads.append(box["grads"])
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(*grads))


def unpartitioned(mesh, cfg, state):
    """The step's arithmetic before it computed partitioned: the whole
    parameters' loss and gradient on this rank's rows, averaged over
    'data', then the optimizer on whole leaves."""
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    _, _, (_, bspecs) = build_train_step(cfg, cell, mesh)
    mine = {k: local_shard(v, bspecs[k], mesh) for k, v in batch.items()}
    state = tree_map(torch.clone, state)
    loss, grads = loss_and_grads(cfg, state["params"], mine)
    axes = axes_of(bspecs["labels"][0])
    loss = mean_over(loss, axes, mesh)
    grads = tree_map(lambda g: mean_over(g, axes, mesh), grads)
    update = (adafactor_update if cfg.optimizer == "adafactor"
              else adamw_update)
    _, _, metrics = update(default_opt_cfg(cfg), grads, state["opt"],
                           state["params"], inplace=True)
    state["step"].add_(1)
    return {"loss": loss, **metrics}, state


out = {}
for key, (data, model) in load("meshes").items():
    mesh = make_test_mesh(data=data, model=model, device_type="cpu")
    coords = {a: mesh.get_local_rank(a) for a in ("data", "model")}
    out[key] = {"coords": coords}
    for name, kw in load("names"):
        cfg = reduced(ARCHS[name], **kw)
        out[key][name] = run(mesh, cfg, load("state_" + name))
        if key == "2x2":
            out[key][name]["other_thread"] = other_thread(
                mesh, cfg, load("state_" + name))
one = make_test_mesh(data=4, model=1, device_type="cpu")
out["4x1"] = {}
for name, kw in load("names"):
    cfg = reduced(ARCHS[name], **kw)
    state = load("state_" + name)
    got = run(one, cfg, state)
    metrics, want = unpartitioned(one, cfg, state)
    out["4x1"][name] = {
        "metrics": sorted(got["metrics"]) == sorted(metrics) and all(
            torch.equal(got["metrics"][k], v) for k, v in metrics.items()),
        "state": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got["local"]), tree_leaves(want)))}

# the collectives' backward passes, at 2 ranks (two groups of 2) and 4
units = {}
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
for size, group in ((2, pairs[RANK // 2]), (4, dist.group.WORLD)):
    rank = dist.get_rank(group)
    axis = ModelAxis(group, size, rank)
    ins = load(f"units_{size}")
    live = {k: v.clone().requires_grad_() for k, v in ins.items()
            if v.is_floating_point()}
    with torch.enable_grad():
        # f and g: a column- then row-parallel pair on this rank's columns
        cols = ins["w1"].shape[1] // size
        w1 = live["w1"][:, rank * cols:(rank + 1) * cols]
        w2 = live["w2"][rank * cols:(rank + 1) * cols]
        h = torch.tanh(copy_to_model(live["x"], axis) @ w1)
        y = reduce_from_model(h @ w2, axis)
        fg = torch.autograd.grad((y * ins["c"]).sum(),
                                 [live["x"], live["w1"], live["w2"]])
        # all_gather_dim: this rank's rows, gathered, replicated compute
        rows = ins["x"].shape[0] // size
        part = live["x"][rank * rows:(rank + 1) * rows]
        whole = all_gather_dim(part, 0, size, group)
        ag = torch.autograd.grad((torch.sin(whole) * ins["c"]).sum(),
                                 live["x"])[0]
        # all_to_all_rows: rank r sends splits[r][d] rows to rank d
        splits = ins["splits"].tolist()
        lo = sum(sum(s) for s in splits[:rank])
        mine = live["x"][lo:lo + sum(splits[rank])]
        got = all_to_all_rows(mine * 1.5, splits[rank],
                              [splits[s][rank] for s in range(size)], group)
        a2a = torch.autograd.grad((torch.cos(got) * (rank + 1)).sum(),
                                  live["x"])[0]
        # glu_regroup of this rank's two blocks of wi's columns
        blocks = live["w1"].reshape(ins["w1"].shape[0], 2 * size, -1)[
            :, 2 * rank:2 * rank + 2].transpose(0, 1)
        gu = glu_regroup(blocks.contiguous(), axis)
        glu = torch.autograd.grad((torch.tanh(gu) * (rank + 1)).sum(),
                                  live["w1"])[0]
        # the vocabulary-parallel loss on this rank's columns
        v = ins["logits"].shape[-1] // size
        with use_model_axis(axis):
            xent = softmax_xent(
                live["logits"][..., rank * v:(rank + 1) * v],
                ins["labels"], z_loss=1e-4, vocab=ins["logits"].shape[-1])
        xg = torch.autograd.grad(xent, live["logits"])[0]
    units[size] = {"fg": fg, "gather": ag, "a2a": a2a, "glu": glu,
                   "xent": xent.detach(), "xent_grad": xg}
out["units"] = units
save("tp_train", out)
'''


@pytest.fixture(scope="module")
def repro_states():
    out = {}
    for name in NAMES:
        jcfg, _ = _cfgs(name)
        out[name] = _np(jax.jit(lambda k: j_make_train_state(jcfg, k))(
            jax.random.key(0)))
    return out


def _units(size):
    """Inputs of the collectives' checks at ``size`` ranks."""
    rng = np.random.default_rng(29 + size)
    splits = rng.integers(0, 3, (size, size))
    splits[0, -1] += 1                  # at least one row moves
    rows = max(int(splits.sum()), 8)
    rows += (-rows) % size
    splits[-1, 0] += rows - int(splits.sum())
    f32 = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    return {"x": f32(rows, 6), "w1": f32(6, 4 * size), "w2": f32(4 * size, 6),
            "c": f32(rows, 6), "splits": torch.tensor(splits),
            "logits": f32(3, 4, 8 * size),
            "labels": torch.tensor(rng.integers(0, 8 * size, (3, 4)))}


@pytest.fixture(scope="module")
def tp_train_run(tmp_path_factory, repro_states):
    d = tmp_path_factory.mktemp("tp_train")
    for name, state in repro_states.items():
        torch.save(train_state_from_jax(state, device="cpu"),
                   d / f"state_{name}.pt")
    torch.save([(n, _kw(n)) for n in NAMES], d / "names.pt")
    torch.save(MESHES, d / "meshes.pt")
    torch.save(CELL, d / "cell.pt")
    for size in (2, 4):
        torch.save(_units(size), d / f"units_{size}.pt")
    spawn(d, WORLD, _RANKS, timeout=300)
    return d, repro_states


@pytest.fixture(scope="module")
def references(tp_train_run):
    """Per arch: the port's single-process loss, gradient and stepped
    state and metrics, and repro's loss, from repro's state."""
    _, states = tp_train_run
    out = {}
    cell = ShapeCell("t", *CELL, "train")
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        state = train_state_from_jax(states[name], device="cpu")
        batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
        loss, grads = loss_and_grads(cfg, state["params"], batch)
        new, metrics = _train_step(cfg, default_opt_cfg(cfg), state, batch,
                                   donate=False)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        out[name] = {"loss": loss, "grads": grads, "state": new,
                     "metrics": metrics,
                     "jloss": float(j_loss_fn(jcfg, states[name]["params"],
                                              jbatch))}
    return out


class _Coords:
    """A mesh stand-in for the spec rules and ``local_shard``: the axes'
    names and sizes and one rank's coordinates on them."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coords):
        self.shape = shape
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


def _within(got, want, tol, scale=None):
    """|got - want| within ``tol`` of ``scale`` (default ``want``'s
    largest entry)."""
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape
    if scale is None:
        scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * max(scale, 1e-30), (err / max(scale, 1e-30), tol)


def _model_shard(t, spec, mesh):
    """``t``'s 'model' shard under ``spec`` (whole over the data axes)."""
    return local_shard(t, tuple(e if e == "model" else None for e in spec),
                       mesh)


def _specs(name, key, coords):
    cfg = _cfgs(name)[1]
    mesh = _Coords(MESHES[key], coords)
    aval, _ = train_state_specs(cfg)
    return mesh, state_pspecs(cfg, aval, mesh)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_partitioned_loss_matches_unsharded_and_repro(tp_train_run,
                                                      references, key, name):
    d, _ = tp_train_run
    ref = references[name]
    for r in range(WORLD):
        got = float(rank_result(d, "tp_train", r)[key][name]["loss"])
        assert abs(got - float(ref["loss"])) <= LOSS_TOL
        assert abs(got - ref["jloss"]) <= LOSS_TOL


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_every_gradient_shard_is_its_slice(tp_train_run, references, key,
                                           name):
    """Each rank's gradient of each leaf (its 'model' shard, whole over
    'data') against that slice of the single-process gradient, within
    GRAD_TOL of the whole leaf's largest entry."""
    d, _ = tp_train_run
    grads = references[name]["grads"]
    for r in range(WORLD):
        res = rank_result(d, "tp_train", r)[key]
        mesh, specs = _specs(name, key, res["coords"])
        got = tree_leaves(res[name]["grads"])
        assert len(got) == len(tree_leaves(grads))
        for g, w, s in zip(got, tree_leaves(grads),
                           tree_leaves(specs["params"])):
            _within(g, _model_shard(w, s, mesh), GRAD_TOL,
                    float(w.abs().max()))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_stepped_state_shards_and_metrics(tp_train_run, references, key,
                                          name):
    """After one step: every rank's shards of every state leaf within
    STATE_TOL of their slices of the single-process state, the metrics
    (``grad_norm`` for AdamW) within LOSS_TOL, the same on every rank."""
    d, _ = tp_train_run
    ref = references[name]
    first = rank_result(d, "tp_train", 0)[key][name]["metrics"]
    assert sorted(first) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(float(first[k]) - float(v)) <= LOSS_TOL * max(
            1.0, abs(float(v))), k
    for r in range(WORLD):
        res = rank_result(d, "tp_train", r)[key]
        for k, v in res[name]["metrics"].items():
            assert torch.equal(v, first[k]), k
        mesh, specs = _specs(name, key, res["coords"])
        local = res[name]["local"]
        assert int(local["step"]) == 1
        for got, want, spec in zip(tree_leaves(local),
                                   tree_leaves(ref["state"]),
                                   tree_leaves(specs)):
            assert got.dtype == want.dtype
            _within(got, local_shard(want, spec, mesh), STATE_TOL,
                    float(want.float().abs().max()))


@pytest.mark.parametrize("name", NAMES)
def test_backward_on_another_thread_recomputes_under_the_axis(tp_train_run,
                                                              name):
    """On the (2, 2) mesh, the gradient of the partitioned loss taken on
    a thread that never entered ``use_model_axis`` (as autograd runs a
    CUDA backward) equals the one taken on the forward's thread, bit for
    bit, on every rank."""
    d, _ = tp_train_run
    for r in range(WORLD):
        assert rank_result(d, "tp_train", r)["2x2"][name][
            "other_thread"] is True


@pytest.mark.parametrize("name", NAMES)
def test_model_size_one_is_bitwise_the_unpartitioned_step(tp_train_run,
                                                          name):
    d, _ = tp_train_run
    for r in range(WORLD):
        assert rank_result(d, "tp_train", r)["4x1"][name] == {
            "metrics": True, "state": True}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_no_train_step_gathers_a_model_shard_whole(tp_train_run, key, name):
    """The bytes of the all-gathers a rank issues in a step stay below
    the whole bytes of the leaves split over 'model' it holds: gathering
    those leaves whole (the step before it was partitioned) took at
    least that."""
    d, _ = tp_train_run
    for r in range(WORLD):
        got = rank_result(d, "tp_train", r)[key][name]
        assert got["split"] > 0
        assert got["gathered"] < got["split"]


def _remat_layers(cfg):
    """The blocks a train step rematerializes: every scanned layer (and
    encoder layer), not the hybrid's shared block."""
    return cfg.n_layers + cfg.encoder_layers


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_saved_block_inputs_are_model_slices_bitwise(tp_train_run, key,
                                                     name):
    """Each rematerialized block's input, saved as the rank's 'model'
    slice and gathered again where the backward recomputes the block: the
    stream is the same bit for bit on every 'model' rank (what makes the
    gather exact), and the loss, every gradient shard, the metrics and
    the stepped state are ``torch.equal`` to the same step with the block
    inputs saved whole, on every rank."""
    d, _ = tp_train_run
    cfg = _cfgs(name)[1]
    for r in range(WORLD):
        got = rank_result(d, "tp_train", r)[key][name]["slices"]
        assert got == {"saved": _remat_layers(cfg), "stream": True,
                       "loss": True, "grads": True, "metrics": True,
                       "state": True}


def _unit_reference(size):
    """The single-process gradients of the ranks' unit checks, summed
    over the ranks where each rank's loss is its own."""
    ins = _units(size)
    live = {k: v.clone().requires_grad_() for k, v in ins.items()
            if v.is_floating_point()}
    y = torch.tanh(live["x"] @ live["w1"]) @ live["w2"]
    fg = torch.autograd.grad((y * ins["c"]).sum(),
                             [live["x"], live["w1"], live["w2"]])
    ag = torch.autograd.grad((torch.sin(live["x"]) * ins["c"]).sum(),
                             live["x"])[0]
    # the all-to-all: rank d receives splits[s][d] rows from each s
    splits = ins["splits"].tolist()
    start = np.cumsum([0] + [sum(s) for s in splits])
    loss = 0
    for dst in range(size):
        rows = [live["x"][start[s] + sum(splits[s][:dst]):
                          start[s] + sum(splits[s][:dst + 1])]
                for s in range(size)]
        loss = loss + (torch.cos(torch.cat(rows) * 1.5) * (dst + 1)).sum()
    a2a = torch.autograd.grad(loss, live["x"])[0]
    # glu_regroup: rank s gets block s of gate and of up
    d_in = ins["w1"].shape[0]
    gate, up = live["w1"].reshape(d_in, 2, size, -1).unbind(1)
    loss = sum((torch.tanh(torch.stack([gate[:, s], up[:, s]])) * (s + 1))
               .sum() for s in range(size))
    glu = torch.autograd.grad(loss, live["w1"])[0]
    from repro_torch.models.layers import softmax_xent
    xent = softmax_xent(live["logits"], ins["labels"], z_loss=1e-4)
    xg = torch.autograd.grad(xent, live["logits"])[0]
    return {"fg": fg, "gather": ag, "a2a": a2a, "glu": glu,
            "xent": xent.detach(), "xent_grad": xg}


@pytest.mark.parametrize("size", [2, 4])
def test_collectives_differentiate_as_the_single_process(tp_train_run, size):
    """f and g around a column- then row-parallel pair: x's gradient
    (f's all-reduce), each rank's columns of w1 and rows of w2;
    ``all_gather_dim``: each rank's rows of the gradient;
    ``all_to_all_rows`` with uneven splits and ``glu_regroup``: the
    inverse all-to-all, summed over the ranks; the vocabulary-parallel
    loss and its gradient.  Every rank of every group, within 1e-6 of
    the single-process gradients."""
    d, _ = tp_train_run
    want = _unit_reference(size)
    ins = _units(size)
    for r in range(WORLD):
        got = rank_result(d, "tp_train", r)["units"][size]
        rank = r % size
        cols = ins["w1"].shape[1] // size
        gx, gw1, gw2 = got["fg"]
        _within(gx, want["fg"][0], 1e-6)
        _within(gw1[:, rank * cols:(rank + 1) * cols],
                want["fg"][1][:, rank * cols:(rank + 1) * cols], 1e-6)
        _within(gw2[rank * cols:(rank + 1) * cols],
                want["fg"][2][rank * cols:(rank + 1) * cols], 1e-6)
        rows = ins["x"].shape[0] // size
        mine = slice(rank * rows, (rank + 1) * rows)
        _within(got["gather"][mine], want["gather"][mine], 1e-6)
        splits = ins["splits"].tolist()
        lo = sum(sum(s) for s in splits[:rank])
        mine = slice(lo, lo + sum(splits[rank]))
        _within(got["a2a"][mine], want["a2a"][mine], 1e-6)
        gate = got["glu"].reshape(ins["w1"].shape[0], 2 * size, -1)
        ref = want["glu"].reshape(ins["w1"].shape[0], 2 * size, -1)
        _within(gate[:, 2 * rank:2 * rank + 2],
                ref[:, 2 * rank:2 * rank + 2], 1e-6)
        assert abs(float(got["xent"]) - float(want["xent"])) <= 1e-6
        v = ins["logits"].shape[-1] // size
        _within(got["xent_grad"][..., rank * v:(rank + 1) * v],
                want["xent_grad"][..., rank * v:(rank + 1) * v], 1e-6)
