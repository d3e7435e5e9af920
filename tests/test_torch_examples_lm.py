"""The port's examples (``examples_torch/``) against ``repro`` on the CPU,
part 2: the LM scripts (quickstart, serve_pipeline, multi_tenant,
durable_serving, train_lm).

Each test loads a port script with ``importlib`` and calls its
``run(device="cpu", ...)`` at the script's model and smaller counts;
``repro``'s side is its library called as its script calls it, on the same
weights and tokens (``lm_params_from_jax``, ``train_state_from_jax``).
``repro``'s ``examples/train_lm.py`` fails at its second step on this JAX
(a ``ShardingTypeError`` in the embedding lookup, four times, then
``exceeded 3 restarts``), so the port's ``train_lm`` is held to
``repro``'s library step ``_train_step`` from the same state.  Losses
within 1e-4 relative, tokens and counters exactly, a resumed run
bitwise.  Nothing is written into the repo tree (``tmp_path``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.core.serving import Request as JaxRequest
from repro.core.serving import SynergyServer as JaxServer
from repro.core.synergy_mm import SynergyTrace as JaxTrace
from repro.data import synthetic_batches as jax_synthetic_batches
from repro.launch import train as jax_train
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import lm_loss as jax_lm_loss
from repro.models import prefill as jax_prefill
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.runtime import StragglerRebalancer as JaxRebalancer
from repro.soc import SynergyRuntime as JaxRuntime
from repro.soc import Tenant as JaxTenant
from repro.soc.qos import QosClass as JaxQosClass
from repro_torch.models import lm_params_from_jax, train_state_from_jax
from repro_torch.tree import tree_leaves
from test_torch_examples_runtime import (  # noqa: F401 (one_thread: autouse)
    _np_tree, example, one_thread)


@functools.lru_cache(maxsize=None)
def _granite(**kw):
    """(repro cfg, repro params from key 0, the same params on the port)."""
    jcfg = jax_reduced(JAX_ARCHS["granite-3-2b"], **kw)
    jparams = jax_init_model(jcfg, jax.random.key(0))
    return jcfg, jparams, lm_params_from_jax(_np_tree(jparams), "cpu")


# --------------------------------------------------------------- quickstart

def test_quickstart_matches_repro():
    """The traced GEMMs, tile jobs and GFLOP exactly ``repro``'s (whose
    ``lax.scan`` traces the layer body once: the port's loop runs it for
    each layer, so its table is the body's ``n_layers`` times, then the
    head), the five AdamW losses within 1e-4 relative and the eight greedy
    tokens equal."""
    jcfg, jparams, params = _granite(n_layers=2, d_model=64)
    key = jax.random.key(0)
    batch = {"tokens": jax.random.randint(key, (4, 32), 0, jcfg.vocab_size),
             "labels": jax.random.randint(key, (4, 32), 0, jcfg.vocab_size)}
    out = example("quickstart").run(
        "cpu", params=params,
        batch={k: torch.from_numpy(np.array(v)) for k, v in batch.items()})

    tr = JaxTrace()
    with tr.activate():
        jax.eval_shape(lambda p: jax_lm_loss(jcfg, p, batch), jparams)
    *body, head = tr.jobsets
    want = [(js.name, js.m, js.n, js.k, js.num_jobs)
            for js in body * jcfg.n_layers + [head]]
    assert [row[1:] for row in out["jobsets"]] == want
    assert out["gemms"] == len(want) == 13
    assert out["tile_jobs"] == sum(r[-1] for r in want)
    assert out["gflop"] == (sum(js.total_flops for js in body)
                            * jcfg.n_layers + head.total_flops) / 1e9

    opt_cfg = JaxAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)

    @jax.jit
    def step(p, o, b):
        loss, grads = jax.value_and_grad(
            lambda q: jax_lm_loss(jcfg, q, b))(p)
        p, o, _ = jax_adamw_update(opt_cfg, grads, o, p)
        return p, o, loss

    p, o, losses = jparams, jax_adamw_init(jparams), []
    for _ in range(5):
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)

    dec = jax.jit(lambda p, c, t, i: jax_decode_step(jcfg, p, c, t, i))
    cache = jax_init_cache(jcfg, 1, 16)
    tok, toks = jnp.zeros((1, 1), jnp.int32), []
    for i in range(8):
        logits, cache = dec(p, cache, tok, jnp.int32(i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(int(tok[0, 0]))
    assert out["greedy"] == toks


# ----------------------------------------------------------- serve_pipeline

def test_serve_pipeline_matches_repro():
    """Three requests through the four stages: each request's tokens equal
    ``repro``'s prefill + greedy decode on the same weights and prompts,
    each request served once; the straggler rebalancer's shares and
    splits exactly ``repro``'s."""
    mod = example("serve_pipeline")
    jcfg, jparams, params = _granite(n_layers=2, d_model=64)
    n = 3
    prompts = {rid: jax.random.randint(jax.random.key(rid),
                                       (1, mod.PROMPT), 0, jcfg.vocab_size)
               for rid in range(n)}
    out = mod.run("cpu", params=params, n_req=n,
                  prompts={rid: np.array(t) for rid, t in prompts.items()})

    pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, tokens=t))
    dec = jax.jit(lambda p, c, t, i: jax_decode_step(jcfg, p, c, t, i))
    for rid, toks in prompts.items():
        logits = pre(jparams, toks)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        cache = jax_init_cache(jcfg, 1, mod.PROMPT + mod.DECODE_TOKENS + 1)
        want = [int(tok[0, 0])]
        for i in range(mod.DECODE_TOKENS):
            logits, cache = dec(jparams, cache, tok,
                                jnp.int32(mod.PROMPT + i))
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            want.append(int(tok[0, 0]))
        assert out["tokens"][rid] == want, rid
    assert sorted(out["tokens"]) == list(range(n))

    for n_req in (n, 12):
        rb = JaxRebalancer(2, ema=0.5)
        shares, rows = rb.shares, []
        for step in range(12):
            shares = rb.observe([shares[0] / 1.0, shares[1] / 0.5])
            if step % 3 == 2:
                rows.append((step, list(shares), list(rb.split_jobs(n_req))))
        assert mod.rebalance(n_req) == rows
    assert [r[2] for r in mod.rebalance(12)] == [[8, 4]] * 4


# ------------------------------------------------------------- multi_tenant

def _repro_tenant_run(mod, jcfg, jparams, n_gold, n_bulk):
    """``repro``'s script at ``n_gold`` / ``n_bulk`` requests, with the
    port's prompts: (each request's tokens, per-tenant counters)."""
    gold_c = JaxQosClass("gold", priority=10, weight=4.0)
    bulk_c = JaxQosClass("bulk", priority=-10, sheddable=True)

    def reqs(base, n, tenant, max_new):
        return [JaxRequest(base + i, jnp.asarray(mod.prompt(base + i)
                                                 .numpy()),
                           max_new_tokens=max_new, tenant=tenant)
                for i in range(n)]

    tokens = {}
    for tenants in (None, [JaxTenant("gold", gold_c),
                           JaxTenant("bulk", bulk_c)]):
        with JaxRuntime(["F-PE", "S-PE"], name="ref") as rt:
            srv = JaxServer(jcfg, jparams, slots=mod.SLOTS, max_len=32,
                            prefill_len=mod.PLEN, runtime=rt,
                            tenants=tenants)
            mode = "qos" if tenants else "fifo"
            rs = (reqs(0, n_bulk, tenants and "bulk", 8)
                  + reqs(5000, n_gold, tenants and "gold", 4))
            for r in rs:
                srv.submit(r)
            stats = srv.run()
            tokens[mode] = {r.rid: list(r.out) for r in rs}
    return tokens, {name: (ts.admitted, ts.tokens_out)
                    for name, ts in sorted(stats.tenants.items())}


def test_multi_tenant_matches_repro():
    """FIFO and QoS servers at 2 gold and 3 bulk requests: the admitted
    requests and tokens per tenant, and each request's tokens on both
    servers, exactly ``repro``'s on the same weights and prompts.  The
    deadline attainment follows wall time and is not compared."""
    mod = example("multi_tenant")
    jcfg, jparams, params = _granite(n_layers=2, d_model=32, n_heads=2,
                                     d_ff=64, vocab=128)
    out = mod.run("cpu", params=params, n_gold=2, n_bulk=3)
    tokens, tenants = _repro_tenant_run(mod, jcfg, jparams, 2, 3)
    got = {name: (ts["admitted"], ts["tokens_out"])
           for name, ts in out["tenants"].items()}
    assert got == tenants == {"bulk": (3, 21), "gold": (2, 6)}
    assert out["tokens"] == tokens


# ---------------------------------------------------------- durable_serving

def test_durable_serving_restores_repro_streams(tmp_path):
    """A real SIGKILL of the serving child after 11 tokens, a restore in
    this process: every request answered once, its stream equal to the
    never-crashed server's and to ``repro``'s on the same weights; the
    journal and counters as ``repro``'s script prints them (12 records,
    3 replayed, 63 fresh, 6 snapshots, 1 restore)."""
    mod = example("durable_serving")
    jcfg, jparams, params = _granite(n_layers=2, d_model=32, n_heads=2,
                                     d_ff=64, vocab=128)
    out = mod.run("cpu", params=params, workdir=str(tmp_path))
    srv = JaxServer(jcfg, jparams, **mod.SERVER_KW)
    reqs = [JaxRequest(i, jnp.arange(mod.PLEN, dtype=jnp.int32) + 3 * i,
                       max_new_tokens=mod.NEW_TOKENS)
            for i in range(mod.N_REQ)]
    for r in reqs:
        srv.submit(r)
    srv.run()
    want = {r.rid: list(r.out) for r in reqs}
    assert out["returncode"] == -9
    assert out["streams"] == out["reference"] == want
    assert (out["journal_records"], out["replayed_tokens"],
            out["tokens_out"], out["snapshots"], out["restores"]) == (
        12, 3, 63, 6, 1)


# ----------------------------------------------------------------- train_lm

def test_train_lm_matches_repro_step_and_resumes_bitwise(tmp_path):
    """The tiny preset at batch 2 x 32 tokens over a one-rank gloo mesh:
    the first three losses within 1e-4 relative of ``repro``'s jitted
    ``_train_step`` from the same state and batches (``repro``'s script
    itself fails at its second step); a run stopped at step 2 and run
    again to step 4 resumes from its checkpoint and ends bitwise the
    state of a run that went to step 4 at once."""
    mod = example("train_lm")
    jcfg = dataclasses.replace(
        jax_reduced(JAX_ARCHS["granite-3-2b"], **mod.PRESETS["tiny"]),
        remat=False)
    jstate = jax_train.make_train_state(jcfg, jax.random.key(0))
    out = mod.run("cpu", steps=3, batch=2, seq=32, ckpt_every=10,
                  ckpt_dir=str(tmp_path / "steps"),
                  state=train_state_from_jax(_np_tree(jstate), "cpu"))
    step = jax.jit(functools.partial(jax_train._train_step, jcfg,
                                     jax_train.default_opt_cfg(jcfg)))
    it = jax_synthetic_batches(jcfg, JaxShapeCell("train", 32, 2, "train"),
                               seed=0)
    losses, state = [], jstate
    for _ in range(3):
        state, metrics = step(state, next(it))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
    assert out["final_step"] == 3 and out["resumed_from"] is None

    kw = dict(batch=2, seq=32, ckpt_every=2)
    whole = mod.run("cpu", steps=4, ckpt_dir=str(tmp_path / "whole"), **kw)
    first = mod.run("cpu", steps=2, ckpt_dir=str(tmp_path / "part"), **kw)
    again = mod.run("cpu", steps=4, ckpt_dir=str(tmp_path / "part"), **kw)
    assert (first["final_step"], again["resumed_from"],
            again["final_step"]) == (2, 2, 4)
    assert [s for s, _, _ in again["log"]] == [3, 4]
    assert again["losses"] == whole["losses"][2:]
    leaves = list(zip(tree_leaves(whole["state"]),
                      tree_leaves(again["state"])))
    assert leaves and all(torch.equal(a, b) for a, b in leaves)
