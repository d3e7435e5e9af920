"""The LM model zoo in the port against repro, on the CPU, for all ten
assigned archs: configs field by field (full and ``reduced``), parameter
trees key for key, and — with repro's own parameters carried across by
``lm_params_from_jax`` — prefill logits and four decode steps with a
per-slot ``pos`` vector (one slot at ``pos < 0``, whose cache rows must
stay untouched), all within 1e-5.  Hybrid (zamba2) runs with
``n_layers=4``, so two groups share the attention block.

MoE routing picks top-k by router score; ``torch.topk`` and
``jax.lax.top_k`` may order tied scores differently, and ties are
improbable on random floats."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduced as j_reduced
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import model_flops as j_model_flops
from repro.models import prefill as j_prefill
from repro.models.transformer import prepare_cross_cache as j_cross_cache
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced
from repro_torch.models import (decode_fn, init_cache, init_model,
                                lm_forward, lm_params_from_jax, model_flops,
                                prefill_fn, prepare_cross_cache)

NAMES = sorted(J_ARCHS)
TOL = 1e-5


def _configs(name):
    kw = {"n_layers": 4} if J_ARCHS[name].family == "hybrid" else {}
    return j_reduced(J_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _params(jcfg):
    jp = j_init_model(jcfg, jax.random.key(0))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _prefill_inputs(cfg, b, s, rng):
    """The same inputs for both packages: (repro kwargs, port kwargs)."""
    arrays = {}
    if cfg.takes_embeddings:
        arrays["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32)
    if cfg.family == "audio":
        arrays["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v).long() if v.dtype == np.int32
             else torch.tensor(v) for k, v in arrays.items()})


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_field_by_field(name):
    jcfg, cfg = J_ARCHS[name], get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        j_reduced(jcfg))
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert cfg.param_torch_dtype == getattr(torch, jcfg.param_jdtype.name)
    assert cfg.compute_torch_dtype == getattr(torch,
                                              jcfg.compute_jdtype.name)
    for cell in SHAPES:
        assert model_flops(cfg, SHAPES[cell]) == j_model_flops(
            jcfg, J_SHAPES[cell])


@pytest.mark.parametrize("name", NAMES)
def test_param_trees_match_key_for_key(name):
    """The port's own init gives repro's keys, shapes and dtypes."""
    jcfg, cfg = _configs(name)
    jp = jax.tree.map(np.asarray, j_init_model(jcfg, jax.random.key(0)))
    tp = init_model(cfg, 0, device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (path, ja), (_, ta) in zip(j_leaves, t_leaves):
        assert tuple(ja.shape) == tuple(ta.shape), path
        assert str(ja.dtype) == str(ta.dtype).removeprefix("torch."), path


def test_bf16_params_cross_exactly():
    """dbrx and kimi keep param_dtype bfloat16: the bits carry across."""
    jcfg = dataclasses.replace(j_reduced(J_ARCHS["dbrx-132b"]),
                               param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init_model(jcfg, jax.random.key(1)))
    tp = lm_params_from_jax(jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    for (path, ja), (_, ta) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(tp)[0]):
        np.testing.assert_array_equal(
            ta.to(torch.float32).numpy(), ja.astype(np.float32),
            err_msg=str(path))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_repro(name):
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg)
    jin, tin = _prefill_inputs(cfg, 2, 16, np.random.default_rng(0))
    logits = prefill_fn(cfg, tp, **tin)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits, j_prefill(jcfg, jp, **jin))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_repro_per_slot(name):
    """Four decode steps, each slot at its own position; slot 2 sits at
    ``pos < 0`` throughout and its caches must stay as they were."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    b, max_len = 3, 12
    jcache = j_init_cache(jcfg, b, max_len, dtype=jnp.float32)
    tcache = init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
    if cfg.family == "audio":
        enc = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        jcache["xk"], jcache["xv"] = j_cross_cache(jcfg, jp,
                                                   jnp.asarray(enc))
        tcache["xk"], tcache["xv"] = prepare_cross_cache(cfg, tp,
                                                         torch.tensor(enc))
    j_step = jax.jit(lambda p, c, t, i: j_decode_step(jcfg, p, c, t, i))
    for step in range(4):
        pos = np.array([step, step + 3, -1], np.int32)
        if cfg.takes_embeddings:
            tok = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
            ttok = torch.tensor(tok)
        else:
            tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
            ttok = torch.tensor(tok).long()
        jlogits, jcache = j_step(jp, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos))
        tlogits, tcache = decode_fn(cfg, tp, tcache, ttok, torch.tensor(pos))
        _close(tlogits[:2], np.asarray(jlogits)[:2])
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tcache)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, ja), (_, ta) in zip(jflat, tflat):
        _close(ta, ja)
    # the masked slot: K/V rows stay zero; SSM states stay zero
    for path, ta in tflat:
        keys = jax.tree_util.keystr(path)
        if "xk" in keys or "xv" in keys:
            continue
        row = ta[:, 2] if ta.dim() >= 2 else ta
        assert not row.any(), keys


def test_impl_variants_agree_on_hybrid():
    """zamba2's prefill with ``impl`` naming both kernels ('cuda': their
    plain versions on the CPU) and both oracles ('ref'), against repro's
    prefill with both oracles, at a length that pads the last chunk."""
    jcfg, cfg = _configs("zamba2-2.7b")
    jp, tp = _params(jcfg)
    jin, tin = _prefill_inputs(cfg, 2, 40, np.random.default_rng(2))
    want = j_prefill(jcfg, jp, impl="ref", **jin)
    for impl in ("cuda", "ref"):
        _close(prefill_fn(cfg, tp, impl=impl, **tin), want)


def test_mixer_probe_sees_each_mixer_on_hybrid():
    """``transformer.mixer_probe`` sees every mixer of zamba2's forward in
    the order the backbone runs them, its ``rerun('ref')`` recomputes the
    mixer on the oracles from the same input, and the probe leaves the
    logits as they are."""
    from repro_torch.models import transformer
    jcfg, cfg = _configs("zamba2-2.7b")
    _, tp = _params(jcfg)
    _, tin = _prefill_inputs(cfg, 2, 40, np.random.default_rng(3))
    want = prefill_fn(cfg, tp, impl="cuda", **tin)
    seen = []

    def probe(kind, out, rerun):
        _close(out, rerun("ref").numpy())
        seen.append(kind)

    transformer.mixer_probe = probe
    try:
        got = prefill_fn(cfg, tp, impl="cuda", **tin)
    finally:
        transformer.mixer_probe = None
    assert seen == (["mamba"] * cfg.attn_every + ["attention"]) * (
        cfg.n_layers // cfg.attn_every)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_incremental_decode_matches_forward(name):
    """Token-by-token decode from an empty cache reproduces the
    full-sequence forward (tests/test_models.py's check, in the port)."""
    _, cfg = _configs(name)
    tp = init_model(cfg, 0, device="cpu")
    b, s = 2, 12
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(3))
    full = lm_forward(cfg, tp, tokens=tokens)
    cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(s):
        logits, cache = decode_fn(cfg, tp, cache, tokens[:, i:i + 1], i)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_tc"])
def test_moe_matches_repro(fn):
    """Expert choice (the zoo's routing) and the token-choice oracle."""
    from repro.models import moe as j_moe
    from repro_torch.models import moe
    jp = j_moe.init_moe(jax.random.key(2), 32, 48, 4)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 24, 32)).astype(
        np.float32)
    kw = {"top_k": 2, "act": "gelu"}
    _close(getattr(moe, fn)(tp, torch.tensor(x), **kw),
           getattr(j_moe, fn)(jp, jnp.asarray(x), **kw))


@pytest.mark.parametrize("name", ["granite-3-2b", "whisper-small"])
def test_loss_matches_repro(name):
    from repro.models import loss_fn as j_loss_fn
    from repro_torch.models import loss_fn
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(4)
    jin, tin = _prefill_inputs(cfg, 2, 12, rng)
    labels = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jin["labels"], tin["labels"] = jnp.asarray(labels), torch.tensor(labels)
    _close(loss_fn(cfg, tp, tin), j_loss_fn(jcfg, jp, jin))
