"""The training path of the port against repro, on the CPU.

* K4's and K5's autograd wrappers: ``ssd(..., impl="cuda")`` and
  ``flash_attention(..., impl="cuda")`` on CPU tensors under autograd run
  through ``SSDFunction`` / ``FlashAttentionFunction`` with their plain
  forward; their input gradients (and the SSD state's path) against
  ``jax.grad`` of repro's ``impl="xla"`` variants within 2e-5, and a
  float64 ``gradcheck`` at a tiny size.  Without autograd no Function runs.
* Remat: loss and gradients bitwise equal with and without it, and the
  scanned blocks recomputed with it.  Donate: the same state bitwise, the
  state's own tensors written, and ``donate=False`` leaves its input
  untouched.  Resume: ``train_loop`` + ``Checkpointer`` +
  ``run_with_recovery`` with a failure after step 3 bitwise equal to an
  uninterrupted run.
* Specs: ``input_specs``/``cache_specs``/``param_specs`` on ``meta``, shape
  and dtype equal to ``jax.eval_shape``'s for all ten full-size archs.

One train step per family against repro's is in test_torch_train_step.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduced as j_reduced
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd import ssd as j_ssd
from repro.models import cache_specs as j_cache_specs
from repro.models import input_specs as j_input_specs
from repro.models import param_specs as j_param_specs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch, prefetch, synthetic_batches
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import SSDFunction, ssd, ssd_cuda
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ops import _prescale
from repro_torch.launch import (build_train_step, loss_and_grads,
                                make_train_state, train_loop,
                                train_state_specs)
from repro_torch.models import cache_specs, input_specs, param_specs
from repro_torch.runtime import run_with_recovery
from repro_torch.tree import tree_leaves

KERNEL_TOL = 2e-5
CELL = (32, 2)                    # seq_len, global batch


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _close(port, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = port.detach().to(torch.float32).numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - ref).max(initial=0.0)) / scale
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# K4 and K5 under autograd
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)) - 1.0,
                      0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), gy, gs


@pytest.mark.parametrize("chunk,l", [(16, 64), (32, 70)])
def test_ssd_function_gradients_match_repro(chunk, l):
    """Gradients of x, dt, a, B, C through y and through the final state:
    the state's gradient has a path (it joins y's in one VJP)."""
    inp, gy, gs = _ssd_inputs(2, l, 3, 16, 8)
    before = ssd_cuda.launches
    ts = _t(*inp, grad=True)
    y, s = ssd(*ts, chunk=chunk, impl="cuda")
    assert ssd_cuda.launches == before       # CPU: the plain version
    loss = (y * torch.tensor(gy)).sum() + (s * torch.tensor(gs)).sum()
    got = torch.autograd.grad(loss, ts)

    def j_loss(*args):
        jy, js = j_ssd(*args, chunk=chunk, impl="xla")
        return jnp.sum(jy * gy) + jnp.sum(js * gs)

    want = jax.grad(j_loss, argnums=tuple(range(5)))(*map(jnp.asarray, inp))
    for g, w in zip(got, want):
        _close(g, w, KERNEL_TOL)


def test_ssd_cuda_runs_the_function_only_under_autograd():
    inp, gy, _ = _ssd_inputs(1, 32, 2, 16, 8)
    xdt, dta = _prescale(*_t(*inp[:3]))
    args = [xdt.contiguous(), dta.contiguous(), *_t(*inp[3:])]
    y0, s0 = ssd_cuda(*args, chunk=16)
    assert y0.grad_fn is None and s0.grad_fn is None
    with torch.no_grad():
        grads_on = [t.detach().requires_grad_() for t in args]
        y1, _ = ssd_cuda(*grads_on, chunk=16)
    assert y1.grad_fn is None
    y2, s2 = ssd_cuda(*grads_on, chunk=16)
    assert type(y2.grad_fn).__name__ == "SSDFunctionBackward"
    assert torch.equal(y2.detach(), y0) and torch.equal(s2.detach(), s0)


def test_ssd_function_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    b, h, l, p, n = 1, 2, 8, 3, 2
    xdt = torch.randn(b, h, l, p, generator=g, dtype=torch.float64)
    dta = -torch.rand(b, h, l, generator=g, dtype=torch.float64)
    bm = torch.randn(b, l, n, generator=g, dtype=torch.float64) * 0.5
    cm = torch.randn(b, l, n, generator=g, dtype=torch.float64) * 0.5
    args = [t.requires_grad_() for t in (xdt, dta, bm, cm)]
    assert torch.autograd.gradcheck(
        lambda *a: SSDFunction.apply(*a, 4), args)


def _qkv(b, hq, hkv, s, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hq, s, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,causal", [(4, 4, True), (4, 2, True),
                                           (4, 1, False)])
def test_flash_function_gradients_match_repro(hq, hkv, causal):
    q, k, v, go = _qkv(2, hq, hkv, 24, 24, 16)
    before = flash_attention_cuda.launches
    ts = _t(q, k, v, grad=True)
    o = flash_attention(*ts, causal=causal, impl="cuda")
    assert flash_attention_cuda.launches == before
    assert type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad((o * torch.tensor(go)).sum(), ts)
    want = jax.grad(lambda *a: jnp.sum(j_flash(*a, causal=causal,
                                               impl="xla") * go),
                    argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        _close(g, w, KERNEL_TOL)
    with torch.no_grad():
        assert flash_attention(*ts, causal=causal, impl="cuda").grad_fn \
            is None


def test_flash_function_gradcheck_float64():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, 5, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 1, 5, 4, generator=g, dtype=torch.float64)
    v = torch.randn(1, 1, 5, 4, generator=g, dtype=torch.float64)
    args = [t.requires_grad_() for t in (q, k, v)]
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda *a: FlashAttentionFunction.apply(*a, causal, 0.5), args)


# ---------------------------------------------------------------------------
# remat, donate, resume
# ---------------------------------------------------------------------------

def _configs(name):
    kw = {"n_layers": 4} if J_ARCHS[name].family == "hybrid" else {}
    return j_reduced(J_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _small_state(cfg, seed=0):
    return make_train_state(cfg, seed, device="cpu")


@pytest.mark.parametrize("name,op", [("zamba2-2.7b", "ssd"),
                                     ("granite-3-2b", "attention"),
                                     ("whisper-small", "attention")])
def test_remat_is_bitwise_and_recomputes(name, op, monkeypatch):
    """Each scanned block runs again in the backward: the mixers' plain
    versions run 3 times per call with remat (forward, recomputation, the
    Function's backward) and 2 without.  Hybrid's shared attention block
    is outside the scan, so its SSD layers are counted."""
    _, cfg = _configs(name)
    assert cfg.remat
    mod, fn = {"ssd": (ssd_ops, "ssd_chunked"),
               "attention": (fa_ops, "attention_ref")}[op]
    plain, calls = getattr(mod, fn), []
    monkeypatch.setattr(mod, fn, lambda *a, **k: (calls.append(1),
                                                  plain(*a, **k))[1])
    params = _small_state(cfg)["params"]
    batch = make_batch(cfg, ShapeCell("t", *CELL, "train"), 0, 0,
                       device="cpu")
    runs = {}
    for remat in (True, False):
        calls.clear()
        runs[remat] = loss_and_grads(
            dataclasses.replace(cfg, remat=remat), params, batch) + (
                len(calls),)
    (l1, g1, n1), (l0, g0, n0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)
    assert n0 > 0 and 2 * n1 == 3 * n0


@pytest.mark.parametrize("name", ["zamba2-2.7b", "dbrx-132b"])
def test_donate_is_bitwise_and_keeps_the_input_without_it(name):
    _, cfg = _configs(name)
    cell = ShapeCell("t", *CELL, "train")
    state = _small_state(cfg)
    keep = copy.deepcopy(state)
    kept, _, _ = build_train_step(cfg, cell, donate=False)
    donated, _, _ = build_train_step(cfg, cell, donate=True)
    a = state
    for step in range(2):
        a, _ = kept(a, make_batch(cfg, cell, 0, step, device="cpu"))
    for x, y in zip(tree_leaves(state), tree_leaves(keep)):
        assert torch.equal(x, y)               # donate=False: untouched
    b = copy.deepcopy(state)
    ptrs = [t.data_ptr() for t in tree_leaves(b)]
    for step in range(2):
        b, _ = donated(b, make_batch(cfg, cell, 0, step, device="cpu"))
    assert [t.data_ptr() for t in tree_leaves(b)] == ptrs   # in place
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


class _Fault(RuntimeError):
    pass


def test_resume_after_a_failure_is_bitwise(tmp_path):
    """The CPU counterpart of examples/train_lm.py: checkpoints every 2
    steps, a failure after step 3, the supervisor restores step 2."""
    _, cfg = _configs("zamba2-2.7b")
    cell = ShapeCell("t", *CELL, "train")
    state0 = _small_state(cfg)
    straight, _ = train_loop(
        cfg, steps=4, cell=cell, state=copy.deepcopy(state0),
        batch_iter=synthetic_batches(cfg, cell, seed=0, device="cpu"))

    ck = Checkpointer(str(tmp_path), keep=2, async_write=True)
    fired, starts = [], []

    def on_step(step, metrics):
        if step == 3 and not fired:
            fired.append(step)
            ck.wait()            # the step-2 checkpoint is on disk
            raise _Fault("injected at step 3")

    def run_steps(start, end, state):
        starts.append(start)
        it = prefetch(synthetic_batches(cfg, cell, seed=0, start_step=start,
                                        device="cpu"), depth=2)
        state, _ = train_loop(cfg, steps=end - start, cell=cell,
                              state=copy.deepcopy(state), batch_iter=it,
                              checkpointer=ck, ckpt_every=2,
                              on_step=on_step)
        ck.wait()
        return state

    resumed, failures = run_with_recovery(steps=4, run_steps=run_steps,
                                          checkpointer=ck, state0=state0)
    assert len(failures) == 1 and "injected" in failures[0].detail
    assert starts == [0, 2]
    assert ck.all_steps() == [2, 4]
    assert int(resumed["step"]) == 4
    for x, y in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_a_mesh_is_taken():
    """``build_train_step`` over a mesh (one gloo rank, in this process)
    returns repro's spec trees, and its step, given the state placed once
    by its specs, gives the single-device step's loss, metrics and state
    bit for bit, written into the placed state's own tensors."""
    import torch.distributed as dist
    from repro_torch.launch import make_test_mesh, place_tree, state_pspecs
    from repro_torch.launch.sharding import P
    _, cfg = _configs("granite-3-2b")
    cell = ShapeCell("t", *CELL, "train")
    state = make_train_state(cfg, 0, device="cpu")
    batch = make_batch(cfg, cell, seed=0, step=0, device="cpu")
    want, want_m = build_train_step(cfg, cell, donate=False)[0](state, batch)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(data=1, model=1, device_type="cpu")
        fn, (aval, sspecs), (ins, bspecs) = build_train_step(cfg, cell,
                                                             mesh)
        assert sspecs == state_pspecs(cfg, aval, mesh)
        assert bspecs == {"tokens": P("data", None),
                          "labels": P("data", None)}
        assert sspecs["params"]["embed"] == P("model", None)
        got, got_m = fn(place_tree(state, sspecs, mesh), batch)
        assert sorted(got_m) == sorted(want_m)
        for k, v in want_m.items():
            assert torch.equal(got_m[k], v), k
        leaves = tree_leaves(got)
        for x, y in zip(leaves, tree_leaves(want)):
            assert torch.equal(x.full_tensor(), y)
        assert all(x.to_local().data_ptr() == y.data_ptr()
                   for x, y in zip(leaves, tree_leaves(state)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# model-zoo specs
# ---------------------------------------------------------------------------

def _spec_pairs(port, ref):
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree_leaves(port)]
    want = [(tuple(a.shape), str(np.dtype(a.dtype)))
            for a in jax.tree.leaves(ref)]
    return got, want


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_specs_match_eval_shape(name):
    jcfg, cfg = J_ARCHS[name], ARCHS[name]
    got, want = _spec_pairs(param_specs(cfg), j_param_specs(jcfg))
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(param_specs(cfg)))
    got, want = _spec_pairs(cache_specs(cfg, 2, 128),
                            j_cache_specs(jcfg, 2, 128))
    assert got == want
    for shape in sorted(J_SHAPES):
        jcell, cell = J_SHAPES[shape], SHAPES[shape]
        specs = input_specs(cfg, cell)
        assert sorted(specs) == sorted(j_input_specs(jcfg, jcell))
        got, want = _spec_pairs(specs, j_input_specs(jcfg, jcell))
        assert got == want


def test_train_state_specs_allocate_nothing():
    cfg = ARCHS["zamba2-2.7b"]
    aval, pspecs = train_state_specs(cfg)
    assert pspecs is None
    leaves = tree_leaves(aval)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in tree_leaves(aval["params"])) \
        == 2_422_386_848
