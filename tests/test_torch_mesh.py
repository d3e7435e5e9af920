"""The port's train and serve steps over a device mesh, on gloo ranks on
the CPU, against the port's single-process steps and against repro.

Each scenario runs once per module in ``spawn``: ``world`` processes, one
gloo rank each, that import the port and never JAX; inputs and results
cross as ``torch.save`` files.  Every process group and every spawn has
a time limit, and a rank that fails takes the others down at once.

* Train step (computed partitioned over 'model'; the gradient's 'model'
  shards gathered for the checks), (pod 2, data 2, model 2) mesh,
  repro's multipod scenarios
  (reduced granite-3-2b, dbrx-132b on Adafactor, mamba2-130m, and a
  reduced zamba2-2.7b with ``n_layers=4``), 16 tokens x 8 rows, from
  repro's train state carried across: the loss within 1e-5 of the port's
  single-process loss and of repro's ``lm_loss``; every gradient leaf
  within 1e-5 of its largest entry; the state after one step within 1e-4
  of each leaf's largest entry (the criterion of
  test_torch_train_step.py); every rank the same loss and metrics.
  With ``donate=False`` the input state's shards stay untouched and the
  step is bitwise the donated one.
* Train step, (data 4, model 2) mesh: reduced granite, the scenario of
  repro's ``test_sharded_loss_matches_single_device``, held to the port's
  own single-process loss (1e-5).
* Serve steps, (data 2, model 2) mesh, 8 rows: reduced granite, zamba2
  (hybrid, ``n_layers=4``) and dbrx with 16 experts (MoE, whose decode
  routes the whole batch as one group and here drops tokens): the prefill
  logits and four decode steps' logits and
  caches within 1e-5 of the port's unsharded ``prefill_fn``/``decode_fn``
  and of repro's, with repro's parameters carried across; the steps take
  the parameters and the cache placed once, before the loop.  Decode with
  ``donate=False`` leaves each input cache untouched and is bitwise the
  donated decode.
"""

import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.launch.train import make_train_state as j_make_train_state
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro.models import prefill as j_prefill
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import make_batch, synthetic_batches
from repro_torch.launch import loss_and_grads, train_loop
from repro_torch.launch.train import _train_step, default_opt_cfg
from repro_torch.models import (decode_fn, init_cache, lm_params_from_jax,
                                prefill_fn, train_state_from_jax)
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN_NAMES = ["granite-3-2b", "dbrx-132b", "mamba2-130m", "zamba2-2.7b"]
SERVE_NAMES = ["granite-3-2b", "zamba2-2.7b", "dbrx-132b"]
TRAIN_CELL = (16, 8)              # seq_len, global batch (repro's)
LOSS_TOL, GRAD_TOL, STATE_TOL, SERVE_TOL = 1e-5, 1e-5, 1e-4, 1e-5
SERVE_B, SERVE_S, MAX_LEN, DECODE_STEPS = 8, 8, 16, 4
#: dbrx serves with 16 experts: its decode's expert choice over the 8
#: rows then drops tokens (capacity 4 of 8), so a rank that routed only
#: its own rows would choose differently
SERVE_KW = {"dbrx-132b": {"n_experts": 16}}

# ---------------------------------------------------------------------------
# gloo ranks in subprocesses
# ---------------------------------------------------------------------------

_PRELUDE = '''
import datetime, os, sys
import torch
import torch.distributed as dist
RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", init_method="file://" + os.path.join(DIR, "pg"), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=60))


def load(name):
    return torch.load(os.path.join(DIR, name + ".pt"))


def save(name, obj):
    torch.save(obj, os.path.join(DIR, f"{name}.{RANK}.pt"))

'''


def spawn(directory, world: int, body: str, timeout: float = 180.0):
    """Run ``body`` (after ``_PRELUDE``) on ``world`` gloo ranks, each a
    process of its own; fail, killing every rank, as soon as one fails
    or the time is up."""
    script = os.path.join(directory, "ranks.py")
    with open(script, "w") as f:
        f.write(_PRELUDE + textwrap.dedent(body)
                + "\ndist.destroy_process_group()\n")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    logs = [open(os.path.join(directory, f"log.{r}.txt"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world),
                               str(directory)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None):
                break
            assert time.monotonic() < deadline, f"ranks ran past {timeout} s"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    for log in logs:
        log.seek(0)
    text = [log.read() for log in logs]
    for log in logs:
        log.close()
    assert not failed, "\n".join(f"rank {r}:\n{text[r][-3000:]}"
                                 for r in failed)
    return text


def rank_result(directory, name: str, rank: int = 0):
    return torch.load(os.path.join(directory, f"{name}.{rank}.pt"))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _configs(name, **kw):
    if J_ARCHS[name].family == "hybrid":
        kw = {"n_layers": 4, **kw}
    return j_reduced(J_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_close(got, want, tol):
    """|got - want| within ``tol`` of ``want``'s largest entry."""
    got = got.detach().to(torch.float32)
    want = want.detach().to(torch.float32)
    assert got.shape == want.shape
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * scale, (err / scale, tol)


def _close(port, ref, tol=SERVE_TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_TRAIN = '''
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import make_batch, synthetic_batches
from repro_torch.launch import (build_train_step, gather_tree,
                                make_test_mesh, place_tree, train_loop)
from repro_torch.launch.sharding import axes_of, gather_data_tree, gather_over
from repro_torch.launch.train import _mesh_loss_and_grads
from repro_torch.tree import tree_leaves, tree_map

cell = ShapeCell("t", *load("cell"), "train")


def whole_over_model(g, spec, mesh):
    # a gradient's 'model' shards, gathered along the dimension split
    for dim, entry in enumerate(spec):
        if "model" in axes_of(entry):
            g = gather_over(g, ("model",), mesh, dim)
    return g


def run(mesh, name, kw):
    cfg = reduced(ARCHS[name], **kw)
    state = load("state_" + name)
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    fn, (_, sspecs), (_, bspecs) = build_train_step(cfg, cell, mesh)
    placed = place_tree(state, sspecs, mesh)
    # the partitioned loss and gradient shards, the shards gathered here
    loss, grads = _mesh_loss_and_grads(
        cfg, mesh, bspecs,
        gather_data_tree(placed["params"], sspecs["params"], mesh), batch)
    grads = tree_map(lambda g, s: whole_over_model(g, s, mesh), grads,
                     sspecs["params"])
    # not donated: a new state; the input's shards stay as they were
    before = [d.to_local().clone() for d in tree_leaves(placed)]
    kept, kept_metrics = build_train_step(cfg, cell, mesh, donate=False)[0](
        placed, batch)
    untouched = all(torch.equal(d.to_local(), b)
                    for d, b in zip(tree_leaves(placed), before))
    apart = all(x.to_local().data_ptr() != y.to_local().data_ptr()
                for x, y in zip(tree_leaves(kept), tree_leaves(placed)))
    new, metrics = fn(placed, batch)
    # donated: the step wrote the placed state's own tensors
    assert all(x is y for x, y in zip(tree_leaves(new), tree_leaves(placed)))
    return {"loss": loss, "grads": grads, "metrics": metrics,
            "state": gather_tree(new),
            "local": tree_map(lambda d: d.to_local().clone(), new),
            "kept": {"untouched": untouched, "apart": apart,
                     "metrics": kept_metrics, "state": gather_tree(kept)}}


multipod = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
save("multipod", {name: run(multipod, name, kw)
                  for name, kw in load("names")})
dp4 = make_test_mesh(data=4, model=2, device_type="cpu")
save("dp4", run(dp4, "granite-3-2b", {}))

# train_loop over the mesh, rank 0 checkpointing the gathered state
cfg = reduced(ARCHS["granite-3-2b"])
ck = Checkpointer(os.path.join(DIR, "ckpt"), async_write=False)
state, history = train_loop(
    cfg, dp4, steps=2, cell=cell, state=load("state_granite-3-2b"),
    batch_iter=synthetic_batches(cfg, cell, seed=0, device="cpu"),
    checkpointer=ck, ckpt_every=2)
save("loop", {"losses": [h["loss"] for h in history],
              "state": gather_tree(state)})
'''


def _kw(name):
    return {"n_layers": 4} if J_ARCHS[name].family == "hybrid" else {}


@pytest.fixture(scope="module")
def repro_states():
    """repro's train state (numpy) for each of TRAIN_NAMES."""
    out = {}
    for name in TRAIN_NAMES:
        jcfg, _ = _configs(name)
        out[name] = _np(jax.jit(lambda k: j_make_train_state(jcfg, k))(
            jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def train_run(tmp_path_factory, repro_states):
    """The ranks' results, and repro's train states."""
    d = tmp_path_factory.mktemp("train")
    for name, state in repro_states.items():
        torch.save(train_state_from_jax(state, device="cpu"),
                   d / f"state_{name}.pt")
    torch.save([(n, _kw(n)) for n in TRAIN_NAMES], d / "names.pt")
    torch.save(TRAIN_CELL, d / "cell.pt")
    spawn(d, 8, _TRAIN)
    return d, repro_states


def _single(name, jstate):
    """The port's single-process loss, gradients and stepped state."""
    _, cfg = _configs(name)
    cell = ShapeCell("t", *TRAIN_CELL, "train")
    state = train_state_from_jax(jstate, device="cpu")
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    loss, grads = loss_and_grads(cfg, state["params"], batch)
    new, metrics = _train_step(cfg, default_opt_cfg(cfg), state, batch,
                               donate=False)
    return loss, grads, new, metrics, batch


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_multipod_train_step_matches_single_process(train_run, name):
    d, states = train_run
    got = rank_result(d, "multipod")[name]
    loss, grads, new, metrics, _ = _single(name, states[name])
    assert torch.isfinite(got["loss"])
    assert abs(float(got["loss"]) - float(loss)) <= LOSS_TOL
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        _rel_close(g, w, GRAD_TOL)
    assert sorted(got["metrics"]) == sorted(metrics)
    for k, v in metrics.items():
        assert abs(float(got["metrics"][k]) - float(v)) <= LOSS_TOL * max(
            1.0, abs(float(v))), k
    assert int(got["state"]["step"]) == 1
    for p, w in zip(tree_leaves(got["state"]), tree_leaves(new)):
        assert p.dtype == w.dtype
        _rel_close(p, w, STATE_TOL)


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_multipod_loss_matches_repro(train_run, name):
    d, states = train_run
    jcfg, cfg = _configs(name)
    batch = make_batch(cfg, ShapeCell("t", *TRAIN_CELL, "train"), seed=0,
                       step=0, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = float(j_loss_fn(jcfg, states[name]["params"], jbatch))
    got = float(rank_result(d, "multipod")[name]["loss"])
    assert abs(got - want) <= LOSS_TOL


def test_every_rank_agrees_and_keeps_its_own_shards(train_run):
    """All eight ranks report the same loss and metrics, bit for bit, and
    gather the same state; each keeps a proper shard of a leaf that the
    mesh splits (granite's ``embed``: vocab over 'model')."""
    d, _ = train_run
    ranks = [rank_result(d, "multipod", r) for r in range(8)]
    for r in ranks[1:]:
        for name in TRAIN_NAMES:
            assert torch.equal(r[name]["loss"], ranks[0][name]["loss"])
            for k, v in r[name]["metrics"].items():
                assert torch.equal(v, ranks[0][name]["metrics"][k])
            for x, y in zip(tree_leaves(r[name]["state"]),
                            tree_leaves(ranks[0][name]["state"])):
                assert torch.equal(x, y)
    whole = ranks[0]["granite-3-2b"]["state"]["params"]["embed"]
    for r, res in enumerate(ranks):
        shard = res["granite-3-2b"]["local"]["params"]["embed"]
        half = whole.shape[0] // 2
        model = r % 2                             # mesh order: pod, data, model
        assert shard.shape == (half, whole.shape[1])
        assert torch.equal(shard, whole[model * half:(model + 1) * half])


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_mesh_train_step_without_donate_keeps_its_input(train_run, name):
    """``donate=False`` over the (2, 2, 2) mesh, on every rank: the input
    state's shards are untouched and none is the new state's storage;
    the new state and metrics are bitwise the donated step's."""
    d, _ = train_run
    for r in range(8):
        got = rank_result(d, "multipod", r)[name]
        kept = got["kept"]
        assert kept["untouched"] and kept["apart"]
        for k, v in got["metrics"].items():
            assert torch.equal(kept["metrics"][k], v), k
        for x, y in zip(tree_leaves(kept["state"]),
                        tree_leaves(got["state"])):
            assert torch.equal(x, y)


def test_dp4_loss_matches_single_process(train_run):
    """repro's test_sharded_loss_matches_single_device on a (4, 2) mesh,
    held to the port's own single-process loss and step."""
    d, states = train_run
    got = rank_result(d, "dp4")
    loss, grads, new, _, _ = _single("granite-3-2b", states["granite-3-2b"])
    assert abs(float(got["loss"]) - float(loss)) <= LOSS_TOL
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        _rel_close(g, w, GRAD_TOL)
    for p, w in zip(tree_leaves(got["state"]), tree_leaves(new)):
        _rel_close(p, w, STATE_TOL)


def test_train_loop_over_the_mesh_matches_single_process(train_run):
    """``train_loop`` over the (4, 2) mesh for 2 steps, rank 0 saving the
    gathered state at step 2: the single-process loop's losses (1e-5) and
    state (1e-4 of each leaf's largest entry), and the checkpoint holds
    the state the ranks gathered, bit for bit."""
    d, states = train_run
    _, cfg = _configs("granite-3-2b")
    cell = ShapeCell("t", *TRAIN_CELL, "train")
    want, history = train_loop(
        cfg, steps=2, cell=cell,
        state=train_state_from_jax(states["granite-3-2b"], device="cpu"),
        batch_iter=synthetic_batches(cfg, cell, seed=0, device="cpu"))
    got = rank_result(d, "loop")
    for a, h in zip(got["losses"], history):
        assert abs(a - h["loss"]) <= LOSS_TOL
    for p, w in zip(tree_leaves(got["state"]), tree_leaves(want)):
        _rel_close(p, w, STATE_TOL)
    ck = Checkpointer(d / "ckpt")
    assert ck.all_steps() == [2]
    saved = ck.restore(got["state"])
    for p, w in zip(tree_leaves(saved), tree_leaves(got["state"])):
        assert torch.equal(p, w)


# ---------------------------------------------------------------------------
# the serve steps
# ---------------------------------------------------------------------------

_SERVE = '''
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import gather_tree, make_test_mesh, place_tree
from repro_torch.launch.serve import build_decode_step, build_prefill_step
from repro_torch.models import init_cache
from repro_torch.tree import tree_leaves

mesh = make_test_mesh(data=2, model=2, device_type="cpu")
out = {}
for name, kw in load("names"):
    cfg = reduced(ARCHS[name], **kw)
    inp = load("inputs_" + name)
    b, s = inp["tokens"].shape
    prefill, (_, pspecs), _ = build_prefill_step(
        cfg, ShapeCell("p", s, b, "prefill"), mesh)
    max_len = inp["max_len"]
    dcell = ShapeCell("d", max_len, b, "decode")
    decode, (_, dspecs), (_, bspecs) = build_decode_step(cfg, dcell, mesh)
    kept_decode = build_decode_step(cfg, dcell, mesh, donate=False)[0]
    params = place_tree(inp["params"], dspecs, mesh)
    fresh = lambda: place_tree(
        init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu"),
        bspecs["cache"], mesh)
    cache, kept = fresh(), fresh()
    logits, kept_logits, untouched = [], [], True
    for step, tok in enumerate(inp["decode"]):
        lg, cache = decode(params, cache, tok, step)
        logits.append(lg)
        # not donated: a new cache; the input's shards stay as they were
        before = [d.to_local().clone() for d in tree_leaves(kept)]
        lg, new = kept_decode(params, kept, tok, step)
        untouched &= all(torch.equal(d.to_local(), x)
                         for d, x in zip(tree_leaves(kept), before))
        kept_logits.append(lg)
        kept = new
    out[name] = {"prefill": prefill(place_tree(inp["params"], pspecs, mesh),
                                    {"tokens": inp["tokens"]}),
                 "decode": logits, "cache": gather_tree(cache),
                 "kept": {"untouched": untouched, "decode": kept_logits,
                          "cache": gather_tree(kept)}}
save("serve", out)
'''


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory, repro_states):
    """The ranks' results, and repro's parameters and inputs (numpy)."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    inputs = {}
    for name in SERVE_NAMES:
        jcfg, cfg = _configs(name, **SERVE_KW.get(name, {}))
        jp = (repro_states[name]["params"] if name not in SERVE_KW else
              _np(jax.jit(lambda k: j_init_model(jcfg, k))(
                  jax.random.key(0))))
        tokens = rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                              dtype=np.int32)
        dec = [rng.integers(0, cfg.vocab_size, (SERVE_B, 1), dtype=np.int32)
               for _ in range(DECODE_STEPS)]
        inputs[name] = (jp, tokens, dec)
        torch.save({"params": lm_params_from_jax(jp, device="cpu"),
                    "tokens": torch.tensor(tokens).long(),
                    "decode": [torch.tensor(t).long() for t in dec],
                    "max_len": MAX_LEN}, d / f"inputs_{name}.pt")
    torch.save([(n, {**_kw(n), **SERVE_KW.get(n, {})})
                for n in SERVE_NAMES], d / "names.pt")
    spawn(d, 4, _SERVE)
    return d, inputs


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_sharded_prefill_matches_unsharded_and_repro(serve_run, name):
    d, inputs = serve_run
    jcfg, cfg = _configs(name, **SERVE_KW.get(name, {}))
    jp, tokens, _ = inputs[name]
    got = rank_result(d, "serve")[name]["prefill"]
    want = prefill_fn(cfg, lm_params_from_jax(jp, device="cpu"),
                      tokens=torch.tensor(tokens).long())
    assert got.shape == (SERVE_B, 1, cfg.padded_vocab)
    _close(got, want.numpy())
    _close(got, j_prefill(jcfg, jp, tokens=jnp.asarray(tokens)))


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_sharded_decode_matches_unsharded_and_repro(serve_run, name):
    """Four decode steps from a fresh cache: logits and every cache leaf,
    on every rank."""
    d, inputs = serve_run
    jcfg, cfg = _configs(name, **SERVE_KW.get(name, {}))
    jp, _, dec = inputs[name]
    tp = lm_params_from_jax(jp, device="cpu")
    tcache = init_cache(cfg, SERVE_B, MAX_LEN, dtype=torch.float32,
                        device="cpu")
    jcache = j_init_cache(jcfg, SERVE_B, MAX_LEN, dtype=jnp.float32)
    j_step = jax.jit(lambda p, c, t, i: j_decode_step(jcfg, p, c, t, i))
    ranks = [rank_result(d, "serve", r)[name] for r in range(4)]
    for step, tok in enumerate(dec):
        want, tcache = decode_fn(cfg, tp, tcache, torch.tensor(tok).long(),
                                 step)
        jlogits, jcache = j_step(jp, jcache, jnp.asarray(tok), step)
        for got in ranks:
            _close(got["decode"][step], want.numpy())
            _close(got["decode"][step], jlogits)
    jflat = jax.tree.leaves(jcache)
    for got in ranks:
        flat = tree_leaves(got["cache"])
        assert len(flat) == len(tree_leaves(tcache)) == len(jflat)
        for g, w, jw in zip(flat, tree_leaves(tcache), jflat):
            _close(g, w.numpy())
            _close(g, jw)


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_sharded_decode_without_donate_keeps_its_input(serve_run, name):
    """``donate=False`` decode over the (2, 2) mesh, on every rank: each
    step leaves its input cache's shards untouched, and the four steps'
    logits and the last cache are bitwise the donated steps'."""
    d, _ = serve_run
    for r in range(4):
        got = rank_result(d, "serve", r)[name]
        kept = got["kept"]
        assert kept["untouched"]
        for a, b in zip(kept["decode"], got["decode"]):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(kept["cache"]),
                        tree_leaves(got["cache"])):
            assert torch.equal(a, b)
