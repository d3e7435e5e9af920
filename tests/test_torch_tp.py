"""The serving steps computed partitioned over 'model', on gloo ranks on
the CPU, against the port's unsharded steps and against repro.

One ``spawn`` (``test_torch_mesh.py``) of 4 gloo ranks runs, for reduced
granite-3-2b (tied embeddings), zamba2-2.7b (hybrid, ``n_layers=4``),
dbrx-132b (16 experts), whisper-small (encoder, cross caches) and
internvl2-1b (GQA: 4 q-heads on 2 kv heads, so on 4 ranks the kv heads
stay whole and each rank takes its q-head's), on a
(data 2, model 2) and a (data 1, model 4) mesh (the second puts the
reduced zamba2's P = 16 at 4 a rank): ``build_prefill_step`` on 8 rows of
8 tokens, and four ``build_decode_step`` steps from a cache placed once.
Held here:

* the prefill logits, each decode step's logits and every rank's cache
  shards within 1e-5 of the port's unsharded ``prefill_fn``/``decode_fn``
  and of repro's, with repro's parameters carried across;
* at a 'model' size of 1 ((data 4, model 1)), bit for bit the unsharded
  steps on the rank's rows;
* no step gathers a 'model'-sharded leaf or cache leaf whole: the bytes
  each rank's all-gathers return in a step stay below the whole bytes of
  the leaves it holds split over 'model'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import prefill as j_prefill
from repro.models.transformer import prepare_cross_cache as j_cross_cache
from repro_torch.launch.sharding import cache_pspecs, local_shard
from repro_torch.models import (decode_fn, init_cache, lm_params_from_jax,
                                prefill_fn)
from repro_torch.tree import tree_leaves

from test_torch_mesh import _configs, _np, rank_result, spawn

NAMES = ["granite-3-2b", "zamba2-2.7b", "dbrx-132b", "whisper-small",
         "internvl2-1b"]
KW = {"dbrx-132b": {"n_experts": 16}}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
B, S, MAX_LEN, STEPS = 8, 8, 16, 4
TOL = 1e-5


def _cfgs(name):
    return _configs(name, **KW.get(name, {}))


_RANKS = '''
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import gather_tree, make_test_mesh, place_tree
from repro_torch.launch.serve import build_decode_step, build_prefill_step
from repro_torch.launch.sharding import axes_of
from repro_torch.models import decode_fn, prefill_fn
from repro_torch.models.transformer import decode_rows_independent
from repro_torch.tree import tree_leaves, tree_map

GATHERED = [0]
_all_gather = dist.all_gather


def counted(parts, t, *a, **k):
    GATHERED[0] += sum(p.numel() * p.element_size() for p in parts)
    return _all_gather(parts, t, *a, **k)


dist.all_gather = counted


def split_bytes(tree, specs):
    # whole bytes of the leaves split over 'model'
    return sum(t.numel() * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(specs))
               if any("model" in axes_of(e) for e in s))


def run(mesh, cfg, inp):
    b, s = inp["tokens" if "tokens" in inp else "embeds"].shape[:2]
    prefill, (_, pspecs), _ = build_prefill_step(
        cfg, ShapeCell("p", s, b, "prefill"), mesh)
    decode, (_, dspecs), (_, bspecs) = build_decode_step(
        cfg, ShapeCell("d", MAX_LEN, b, "decode"), mesh)
    batch = {k: inp[k] for k in ("tokens", "embeds", "enc_embeds")
             if k in inp}
    placed = place_tree(inp["params"], pspecs, mesh)
    GATHERED[0] = 0
    logits = prefill(placed, batch)
    gathered = {"prefill": GATHERED[0]}
    params = place_tree(inp["params"], dspecs, mesh)
    cache = place_tree(tree_map(torch.clone, inp["cache"]), bspecs["cache"],
                       mesh)
    steps, gathered["decode"] = [], []
    for i, tok in enumerate(inp["decode"]):
        GATHERED[0] = 0
        lg, cache = decode(params, cache, tok, i)
        gathered["decode"].append(GATHERED[0])
        steps.append(lg)
    return {"prefill": logits, "decode": steps,
            "local": tree_map(lambda d: d.to_local().clone(), cache),
            "cache": gather_tree(cache), "gathered": gathered,
            "split": {"prefill": split_bytes(inp["params"], pspecs),
                      "decode": split_bytes(inp["params"], dspecs)
                      + split_bytes(inp["cache"], bspecs["cache"])}}


def unsharded_on_my_rows(mesh, cfg, inp):
    # the port's unsharded steps on this rank's rows of a (4, 1) mesh
    rows = slice(mesh.get_local_rank("data") * 2,
                 mesh.get_local_rank("data") * 2 + 2)
    split = decode_rows_independent(cfg)
    mine = rows if split else slice(None)
    kw = {k: inp[k][rows] for k in ("tokens", "embeds", "enc_embeds")
          if k in inp}
    want = {"prefill": prefill_fn(cfg, inp["params"], **kw)}
    cache = tree_map(lambda t: t[:, mine].clone(), inp["cache"])
    want["decode"] = []
    for i, tok in enumerate(inp["decode"]):
        lg, cache = decode_fn(cfg, inp["params"], cache, tok[mine], i)
        want["decode"].append(lg[rows] if not split else lg)
    want["cache"] = (cache if split else
                     tree_map(lambda t: t[:, rows], cache))
    return want


out = {}
for key, (data, model) in load("meshes").items():
    mesh = make_test_mesh(data=data, model=model, device_type="cpu")
    coords = {a: mesh.get_local_rank(a) for a in ("data", "model")}
    out[key] = {"coords": coords}
    for name, kw in load("names"):
        out[key][name] = run(mesh, reduced(ARCHS[name], **kw),
                             load("inputs_" + name))
one = make_test_mesh(data=4, model=1, device_type="cpu")
out["4x1"] = {}
for name, kw in load("names"):
    cfg = reduced(ARCHS[name], **kw)
    inp = load("inputs_" + name)
    got = run(one, cfg, inp)
    want = unsharded_on_my_rows(one, cfg, inp)
    rows = slice(one.get_local_rank("data") * 2,
                 one.get_local_rank("data") * 2 + 2)
    split = decode_rows_independent(cfg)
    out["4x1"][name] = {
        "prefill": torch.equal(got["prefill"][rows], want["prefill"]),
        "decode": all(torch.equal(g[rows], w) for g, w in
                      zip(got["decode"], want["decode"])),
        "cache": all(torch.equal(g, w) for g, w in zip(
            tree_leaves(got["local"]), tree_leaves(want["cache"])))}
save("tp", out)
'''.replace("MAX_LEN", str(MAX_LEN))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The ranks' results, and repro's parameters and inputs (numpy)."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(28)
    inputs = {}
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        jp = _np(jax.jit(lambda k: j_init_model(jcfg, k))(
            jax.random.key(0)))
        if cfg.takes_embeddings:     # whisper's decoder: a frontend stub
            arrays = {"embeds": rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)}
        else:
            arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)}
        cache = init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                           device="cpu")
        jcache = _np(j_init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32))
        if cfg.family == "audio":
            arrays["enc_embeds"] = rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
            xk, xv = _np(j_cross_cache(jcfg, jp,
                                       jnp.asarray(arrays["enc_embeds"])))
            jcache["xk"], jcache["xv"] = xk, xv
            cache["xk"], cache["xv"] = torch.tensor(xk), torch.tensor(xv)
        dec = [rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
               if cfg.takes_embeddings else
               rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
               for _ in range(STEPS)]
        inputs[name] = (jp, arrays, dec, jcache)
        torch.save({"params": lm_params_from_jax(jp, device="cpu"),
                    **_port_kwargs(arrays),
                    "decode": [_tensor(t) for t in dec],
                    "cache": cache}, d / f"inputs_{name}.pt")
    torch.save([(n, {**({"n_layers": 4} if n == "zamba2-2.7b" else {}),
                     **KW.get(n, {})}) for n in NAMES], d / "names.pt")
    torch.save(MESHES, d / "meshes.pt")
    spawn(d, WORLD, _RANKS, timeout=300)
    return d, inputs


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _tensor(a):
    return torch.tensor(a).long() if a.dtype == np.int32 else torch.tensor(a)


def _port_kwargs(arrays):
    return {k: _tensor(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def references(tp_run):
    """Per arch: the unsharded port's and repro's prefill logits, decode
    logits and final caches."""
    _, inputs = tp_run
    out = {}
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        jp, arrays, dec, jcache = inputs[name]
        tp = lm_params_from_jax(jp, device="cpu")
        ref = {"prefill": prefill_fn(cfg, tp, **_port_kwargs(arrays)),
               "jprefill": np.asarray(j_prefill(
                   jcfg, jp, **{k: jnp.asarray(v)
                                for k, v in arrays.items()}))}
        tcache = init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                            device="cpu")
        if cfg.family == "audio":
            tcache["xk"] = torch.tensor(jcache["xk"])
            tcache["xv"] = torch.tensor(jcache["xv"])
        jc = jax.tree.map(jnp.asarray, jcache)
        j_step = jax.jit(lambda p, c, t, i: j_decode_step(jcfg, p, c, t, i))
        ref["decode"], ref["jdecode"] = [], []
        for i, tok in enumerate(dec):
            lg, tcache = decode_fn(cfg, tp, tcache, _tensor(tok), i)
            jl, jc = j_step(jp, jc, jnp.asarray(tok), i)
            ref["decode"].append(lg)
            ref["jdecode"].append(np.asarray(jl))
        ref["cache"], ref["jcache"] = tcache, _np(jc)
        out[name] = ref
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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_partitioned_prefill_matches_unsharded_and_repro(tp_run, references,
                                                         key, name):
    d, _ = tp_run
    ref = references[name]
    for r in range(WORLD):
        got = rank_result(d, "tp", r)[key][name]["prefill"]
        assert got.shape == (B, 1, _cfgs(name)[1].padded_vocab)
        _close(got, ref["prefill"].numpy())
        _close(got, ref["jprefill"])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_partitioned_decode_matches_unsharded_and_repro(tp_run, references,
                                                        key, name):
    """Four decode steps' logits on every rank, and the caches gathered
    after them."""
    d, _ = tp_run
    ref = references[name]
    for r in range(WORLD):
        got = rank_result(d, "tp", r)[key][name]
        for step in range(STEPS):
            _close(got["decode"][step], ref["decode"][step].numpy())
            _close(got["decode"][step], ref["jdecode"][step])
        flat, jflat = tree_leaves(got["cache"]), jax.tree.leaves(ref["jcache"])
        assert len(flat) == len(tree_leaves(ref["cache"])) == len(jflat)
        for g, w, jw in zip(flat, tree_leaves(ref["cache"]), jflat):
            _close(g, w.numpy())
            _close(g, jw)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_every_cache_shard_is_the_ranks_slice(tp_run, references, key, name):
    """Each rank's own cache shards (``to_local``) after four steps equal
    its slice, by ``cache_pspecs``, of the unsharded cache: written in
    place, on the head dim (attention) and on P (Mamba2 state)."""
    d, _ = tp_run
    cfg = _cfgs(name)[1]
    ref = references[name]["cache"]
    for r in range(WORLD):
        res = rank_result(d, "tp", r)[key]
        mesh = _Coords(MESHES[key], res["coords"])
        specs = cache_pspecs(cfg, ref, mesh, B)
        for g, w, spec in zip(tree_leaves(res[name]["local"]),
                              tree_leaves(ref), tree_leaves(specs)):
            _close(g, local_shard(w, spec, mesh).numpy())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_no_step_gathers_a_model_shard_whole(tp_run, key, name):
    """The bytes a rank's all-gathers return in a step (the logits over
    'model', activations) stay below the whole bytes of the parameter
    and cache leaves split over 'model' it holds: the gather-whole scheme
    gathered at least those."""
    d, _ = tp_run
    for r in range(WORLD):
        got = rank_result(d, "tp", r)[key][name]
        assert got["split"]["prefill"] > 0 and got["split"]["decode"] > 0
        assert got["gathered"]["prefill"] < got["split"]["prefill"]
        for n in got["gathered"]["decode"]:
            assert n < got["split"]["decode"]


@pytest.mark.parametrize("name", NAMES)
def test_model_size_one_is_bitwise_the_unsharded_step(tp_run, name):
    """On a (data 4, model 1) mesh the steps take the single-process path:
    each rank's prefill and decode logits and cache rows equal the
    unsharded steps' on its rows bit for bit."""
    d, _ = tp_run
    for r in range(WORLD):
        assert rank_result(d, "tp", r)["4x1"][name] == {
            "prefill": True, "decode": True, "cache": True}



def test_layouts_no_config_makes_are_refused():
    """A rank's 'model' shards in a layout the spec tables never produce
    are refused before any collective: ``wi`` split with ``wo`` whole,
    and decode heads split with the head dim whole."""
    from repro_torch.models.attention import (from_cache_layout,
                                              to_cache_layout)
    from repro_torch.models.layers import glu_mlp
    from repro_torch.models.partition import ModelAxis, use_model_axis
    d, d_ff = 8, 6
    params = {"wi": torch.zeros(d, d_ff), "wo": torch.zeros(d_ff, d)}
    with use_model_axis(ModelAxis(group=None, size=2, rank=0)):
        with pytest.raises(ValueError, match="wo's 6 rows whole"):
            glu_mlp(params, torch.zeros(1, 2, d), d_ff=d_ff)
        with pytest.raises(ValueError, match="head dim 5 whole"):
            to_cache_layout(torch.zeros(1, 2, 1, 5), 4, 5)
        with pytest.raises(ValueError, match="head dim 5 whole"):
            from_cache_layout(torch.zeros(1, 4, 1, 5), 2, 5)
