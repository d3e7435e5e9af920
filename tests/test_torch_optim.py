"""The port's optimizers and gradient compression on the CPU: the six tests
of tests/test_optim.py on the port, and the port against repro on the
same numpy inputs — AdamW and Adafactor (factored and unfactored leaves,
stacked ones taken slice by slice) over 5 steps within 1e-6 relative, ``cosine_lr`` at step 0, the end of
warm-up, mid-decay and the end, ``global_norm`` and
``clip_by_global_norm``, and ``compress_tree`` / ``decompress_tree`` /
``init_error_feedback`` / ``quantize_int8`` bitwise (the int8 codes, the
scales and the pads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.optim import adafactor as adafactor_mod
from repro_torch.optim import (AdafactorConfig, AdamWConfig,
                               adafactor_init, adafactor_update, adamw_init,
                               adamw_update, clip_by_global_norm,
                               compress_tree, cosine_lr, decompress_tree,
                               dequantize_int8, global_norm,
                               init_error_feedback, quantize_int8)
from repro_torch.tree import tree_leaves

REL = 1e-6


def _quadratic_losses(update_fn, init_fn, cfg, steps=60):
    w = torch.tensor([[2.0, -3.0], [1.0, 4.0]] * 32).reshape(64, 2)
    params = {"w": w}
    state = init_fn(params)
    losses = []
    for _ in range(steps):
        live = params["w"].detach().requires_grad_()
        loss = torch.mean(live ** 2)
        grads = {"w": torch.autograd.grad(loss, live)[0]}
        params, state, _ = update_fn(cfg, grads, state, params)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                      total_steps=1000)
    losses = _quadratic_losses(adamw_update, adamw_init, cfg, steps=180)
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_decreases_quadratic():
    cfg = AdafactorConfig(lr=0.05)
    losses = _quadratic_losses(adafactor_update, adafactor_init, cfg)
    assert losses[-1] < 0.2 * losses[0]


def test_adafactor_factored_memory():
    params = {"w": torch.zeros((64, 128))}
    state = adafactor_init(params)
    stats = state["stats"]["w"]
    assert stats["vr"].shape == (64,) and stats["vc"].shape == (128,)
    n_stat = stats["vr"].numel() + stats["vc"].numel()
    assert n_stat < params["w"].numel() // 10


def test_int8_roundtrip_error_small():
    x = torch.tensor(np.random.default_rng(0).standard_normal(1000) * 3.0,
                     dtype=torch.float32)
    q, s, pad = quantize_int8(x)
    deq = dequantize_int8(q, s, pad, x.shape)
    assert float((deq - x).abs().max()) < float(x.abs().max()) / 64


def test_error_feedback_accumulates_to_truth():
    """Repeatedly syncing the same gradient with error feedback converges
    to the uncompressed sum (bias vanishes)."""
    g = {"w": torch.tensor(np.random.default_rng(1).standard_normal(512)
                           * 0.1, dtype=torch.float32)}
    err = init_error_feedback(g)
    total = torch.zeros((512,))
    for _ in range(50):
        q, err = compress_tree(g, err)
        total = total + dequantize_int8(q["w"][0], q["w"][1],
                                        (-512) % 256, (512,))
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=1e-3)


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.ones((4,)) * 2}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-5


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


#: "b": a matrix too narrow to factor, "w": factored, "s": stacked (3-D,
#: three slices), "u": stacked and too narrow to factor (four slices)
SHAPES = {"b": (7,), "n": (16, 40), "w": (48, 64), "s": (3, 32, 36),
          "u": (4, 5, 8)}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _rel_close(port, ref, rel=REL):
    got, want = port.detach().numpy(), np.asarray(ref)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * scale


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_matches_repro_over_five_steps(which):
    cfg, jcfg, init, jinit, update, jupdate = {
        "adamw": (AdamWConfig(warmup_steps=2, total_steps=10),
                  jopt.AdamWConfig(warmup_steps=2, total_steps=10),
                  adamw_init, jopt.adamw_init, adamw_update,
                  jopt.adamw_update),
        "adafactor": (AdafactorConfig(weight_decay=0.01),
                      jopt.AdafactorConfig(weight_decay=0.01),
                      adafactor_init, jopt.adafactor_init, adafactor_update,
                      jopt.adafactor_update)}[which]
    params = _tree(0, SHAPES)
    p, jp = _t(params), {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = init(p), jinit(jp)
    for step in range(5):
        grads = _tree(10 + step, SHAPES, scale=0.3 * (step + 1))
        p, state, metrics = update(cfg, _t(grads), state, p)
        jp, jstate, jmetrics = jupdate(
            jcfg, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        assert sorted(metrics) == sorted(jmetrics)
        for k in metrics:
            _rel_close(metrics[k], jmetrics[k])
        for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
            _rel_close(a, b)
        moments = {k: v for k, v in state.items() if k != "step"}
        jmoments = {k: v for k, v in jstate.items() if k != "step"}
        leaves = tree_leaves(moments)
        assert len(leaves) == len(jax.tree.leaves(jmoments))
        for a, b in zip(leaves, jax.tree.leaves(jmoments)):
            assert a.shape == b.shape
            _rel_close(a, b)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_inplace_update_is_bitwise_the_functional_one(which):
    cfg, init, update = {
        "adamw": (AdamWConfig(), adamw_init, adamw_update),
        "adafactor": (AdafactorConfig(), adafactor_init,
                      adafactor_update)}[which]
    p = _t(_tree(0, SHAPES))
    state = init(p)
    grads = _t(_tree(1, SHAPES))
    new_p, new_state, _ = update(cfg, grads, state, p)
    ptrs = [t.data_ptr() for t in tree_leaves({"p": p, "s": state})]
    got_p, got_state, _ = update(cfg, grads, state, p, inplace=True)
    assert got_p is p and got_state is state
    assert [t.data_ptr() for t in tree_leaves({"p": p, "s": state})] == ptrs
    for a, b in zip(tree_leaves({"p": new_p, "s": new_state}),
                    tree_leaves({"p": got_p, "s": got_state})):
        assert torch.equal(a, b)


def test_adafactor_sliced_finer_matches_repro_and_is_inplace_bitwise(
        monkeypatch):
    """Slices finer than a stacked leaf's first dimension (one slice of a
    (2, 3, 32, 36) leaf is (32, 36) once ``SLICE_BYTES`` is below
    3·32·36 floats): five steps within REL of repro, and the in-place
    update bit for bit the functional one."""
    monkeypatch.setattr(adafactor_mod, "SLICE_BYTES", 32 * 36 * 4)
    shapes = {"s4": (2, 3, 32, 36), "u4": (2, 3, 5, 8), "w": (48, 64)}
    assert len(adafactor_mod._slices(shapes["s4"])) == 6
    cfg = AdafactorConfig(weight_decay=0.01)
    jcfg = jopt.AdafactorConfig(weight_decay=0.01)
    params = _tree(7, shapes)
    p, jp = _t(params), {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = adafactor_init(p), jopt.adafactor_init(jp)
    for step in range(5):
        grads = _tree(20 + step, shapes, scale=0.3 * (step + 1))
        want_p, want_s, _ = adafactor_update(cfg, _t(grads), state, p)
        p, state, _ = adafactor_update(cfg, _t(grads), state, p,
                                       inplace=True)
        for a, b in zip(tree_leaves({"p": want_p, "s": want_s}),
                        tree_leaves({"p": p, "s": state})):
            assert torch.equal(a, b)
        jp, jstate, _ = jopt.adafactor_update(
            jcfg, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
            _rel_close(a, b)
        stats = {k: v for k, v in state.items() if k != "step"}
        jstats = {k: v for k, v in jstate.items() if k != "step"}
        for a, b in zip(tree_leaves(stats), jax.tree.leaves(jstats)):
            _rel_close(a, b)


def test_adafactor_temporaries_are_one_slices():
    """A traced in-place update of a stacked (L, r, c) fp32 leaf on
    ``meta``: the storages it makes peak within three slices' fp32 bytes
    plus its (L, r) and (L, c) statistics, where the whole leaf's fp32
    temporaries alone would be L slices."""
    L, r, c = 16, 64, 96
    meta = lambda *s: torch.empty(s, device="meta")
    params, grads = {"w": meta(L, r, c)}, {"w": meta(L, r, c)}
    state = {"stats": {"w": {"vr": meta(L, r), "vc": meta(L, c)}},
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    _, acct = analyze_step(adafactor_update, AdafactorConfig(), grads,
                           state, params, inplace=True)
    one = r * c * 4
    stats = 4 * L * (r + c)
    assert one * L > 8 * one
    assert acct.peak_bytes <= 3 * one + 2 * stats, (acct.peak_bytes, one)


class _CountingSplit:
    """A stand-in for ``launch/sharding.py::LeafSplit`` with one axis of
    two ranks on each dimension named: its sums record the shapes they
    would all-reduce (one collective an axis) and sum nothing."""

    def __init__(self, dims):
        self.dims = dims
        self.sums = []

    def _axes(self, of=None):
        if of is None:
            return [a for d in self.dims for a in d]
        return [a for d in ((of,) if isinstance(of, int) else of)
                for a in self.dims[d]]

    def ranks(self, of=None):
        return 2 ** len(self._axes(of))

    def sum(self, t, of=None):
        self.sums += [tuple(t.shape)] * len(self._axes(of))
        return t


@pytest.mark.parametrize("split_dim", [0, 1, 2])
def test_adafactor_sliced_collectives_per_leaf(split_dim):
    """With ``split``, a stacked (L, r, c) leaf split over one axis on one
    dimension: the collectives of a leaf taken whole, one a mean, with
    the whole leaf's shapes: ``g²``'s row means (L, r) where c is split,
    its column means (L, c) and ``vr``'s mean (L, 1) where r is split,
    the update's square (a scalar) always."""
    L, r, c = 4, 32, 40
    dims = tuple(("model",) if d == split_dim else () for d in range(3))
    sp = _CountingSplit(dims)
    g = torch.ones(L, r, c)
    p = torch.ones(L, r, c)
    state = adafactor_init({"w": p})
    adafactor_update(AdafactorConfig(), {"w": g}, state, {"w": p},
                     split={"w": sp})
    want = {0: [()], 1: [(L, c), (L, 1), ()], 2: [(L, r), ()]}[split_dim]
    assert sp.sums == want


def test_cosine_lr_matches_repro():
    cfg, jcfg = (AdamWConfig(warmup_steps=100, total_steps=1000),
                 jopt.AdamWConfig(warmup_steps=100, total_steps=1000))
    for step in (0, 1, 100, 550, 1000, 1200):
        got = cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.cosine_lr(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        _rel_close(got, want)


def test_global_norm_and_clip_match_repro():
    tree = _tree(3, SHAPES, scale=0.5)
    for max_norm in (0.1, 1e3):
        got, norm = clip_by_global_norm(_t(tree), max_norm)
        want, jnorm = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        _rel_close(norm, jnorm)
        _rel_close(global_norm(_t(tree)), jopt.global_norm(tree))
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            _rel_close(a, b)


def test_compression_is_bitwise_repro():
    tree = _tree(4, {"a": (300,), "b": (16, 16), "c": (5, 7, 11)})
    err = _tree(5, {"a": (300,), "b": (16, 16), "c": (5, 7, 11)},
                scale=1e-3)
    for _ in range(2):       # the second round carries the first's error
        q, new_err = compress_tree(_t(tree), _t(err))
        jq, jerr = jopt.compress_tree(
            {k: jnp.asarray(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in err.items()})
        for k in tree:
            assert q[k][0].dtype == torch.int8
            np.testing.assert_array_equal(q[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            np.testing.assert_array_equal(q[k][1].numpy(),
                                          np.asarray(jq[k][1]))
            np.testing.assert_array_equal(new_err[k].numpy(),
                                          np.asarray(jerr[k]))
        got = decompress_tree(q, _t(tree))
        want = jopt.decompress_tree(jq, {k: jnp.asarray(v)
                                         for k, v in tree.items()})
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        err = {k: new_err[k].numpy() for k in tree}
    zeros = init_error_feedback(_t(tree))
    jzeros = jopt.init_error_feedback(tree)
    for k in tree:
        assert zeros[k].dtype == torch.float32
        np.testing.assert_array_equal(zeros[k].numpy(), np.asarray(jzeros[k]))
    x = (np.random.default_rng(6).standard_normal(1000) * 3).astype(
        np.float32)
    x[::97] = 0.5            # halves: round half to even in both
    q, s, pad = quantize_int8(torch.tensor(x))
    jq, js, jpad = jopt.quantize_int8(jnp.asarray(x))
    assert pad == jpad == 24
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
