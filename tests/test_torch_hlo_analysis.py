"""The port's ``launch/hlo_analysis.py`` against repro's.

* The copy: ``analyze_hlo`` of the port and of repro give equal
  ``to_dict()`` on the same HLO texts (repro's 6-layer scan on 4 host
  devices, from a subprocess; a reduced granite-3-2b prefill).
* ``analyze_step``, the accounting of a traced step: a 6-step loop whose
  weight is sharded over 'model' on a fake 4-rank mesh (a subprocess:
  the fake group is process-global) counts a collective per step and
  every step's flops, as repro's scan test holds ``analyze_hlo``;
  flops at one rank equal repro's ``analyze_hlo`` of the same step,
  prefill and decode exactly, train within 1 % once the forward that
  the K4/K5 plain VJPs recompute from their saved inputs is added (repro
  differentiates its XLA formulations without recomputing them); the
  kernels' ``meta`` routes report their plain formulations' flops; the
  peak, output and alias bytes of a hand-built chain are exact.
* The ``meta`` routes of the five checked wrappers give the plain
  versions' shapes and dtypes, move no launch count, and CPU tensors
  still take the plain versions; GEMMs on ``meta`` rank as on the card
  only inside a traced step.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.launch.hlo_analysis import analyze_hlo as j_analyze_hlo
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core.synergy_mm import synergy_matmul
from repro_torch.engines import get_engine
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.qmm import ops as qmm_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.tiled_mm import ops as tiled_ops
from repro_torch.kernels.vpu_mm import ops as vpu_ops
from repro_torch.launch.hlo_analysis import (TOP_ORIGINS, analyze_hlo,
                                             analyze_step, step_phase)
from repro_torch.launch.train import build_train_step
from repro_torch.models import (decode_fn, init_model, input_specs, loss_fn,
                                prefill_fn)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH_NAMES = ("granite-3-2b", "dbrx-132b", "mamba2-130m", "zamba2-2.7b")
SEQ, BATCH = 64, 8


def _run(script: str, env: dict | None = None, timeout: int = 240) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "PYTHONPATH": SRC,
                              **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the copy
# ---------------------------------------------------------------------------

_SCAN_HLO = """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
mesh = jax.make_mesh((4,), ("model",))
w = jnp.zeros((6, 64, 64))
x = jnp.zeros((8, 64))

def f(w, x):
    def body(h, wi):
        return jnp.dot(h, wi), None
    h, _ = jax.lax.scan(body, x, w)
    return h

jf = jax.jit(f, in_shardings=(NamedSharding(mesh, P(None, None, "model")),
                              NamedSharding(mesh, P(None, None))))
print(jf.lower(w, x).compile().as_text())
"""


def _j_step_hlo(name: str, kind: str) -> str:
    """repro's jitted step of the reduced ``name`` at SEQ x BATCH,
    compiled on a (1, 1) mesh of this process's one CPU device."""
    cfg = j_reduced(J_ARCHS[name])
    cell = JShapeCell("c", SEQ, BATCH, kind)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh, jax.set_mesh(mesh):
        if kind == "train":
            jfn, (aval, _), (ins, _) = j_train.build_train_step(
                cfg, cell, mesh, donate=False)
            lowered = jfn.lower(aval, ins)
        elif kind == "prefill":
            jfn, (aval, _), (ins, _) = j_serve.build_prefill_step(
                cfg, cell, mesh)
            lowered = jfn.lower(aval, ins)
        else:
            jfn, (aval, _), (ins, _) = j_serve.build_decode_step(
                cfg, cell, mesh, donate=False)
            lowered = jfn.lower(aval, ins["cache"], ins["tokens"],
                                ins["pos"])
        return lowered.compile().as_text()


@pytest.mark.parametrize("source", ["scan", "prefill"])
def test_analyze_hlo_is_repros(source):
    if source == "scan":
        text = _run(_SCAN_HLO, env={
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    else:
        text = _j_step_hlo("granite-3-2b", "prefill")
    want = j_analyze_hlo(text).to_dict()
    got = analyze_hlo(text).to_dict()
    assert got == want
    assert want["flops"] > 0
    if source == "scan":
        assert sum(want["count_by_type"].values()) >= 6


# ---------------------------------------------------------------------------
# analyze_step
# ---------------------------------------------------------------------------

def test_step_counts_every_loop_step():
    """repro's ``test_hlo_analysis_counts_scan_trips`` for a traced step:
    6 steps, each weight sharded over 'model' on a fake 4-rank mesh and
    gathered whole for its product (the port's scheme), each step's
    collective and flops seen."""
    out = _run("""
        import json, torch
        from repro_torch.launch.dryrun import start_fake_group
        from repro_torch.launch.hlo_analysis import analyze_step
        from repro_torch.launch.sharding import P, gather_tree, place_tree
        from torch.distributed.device_mesh import init_device_mesh
        start_fake_group(4)
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        layers = [f"w{i}" for i in range(6)]
        w = place_tree({k: torch.empty(64, 64, device="meta")
                        for k in layers},
                       {k: P(None, "model") for k in layers}, mesh)
        x = torch.empty(8, 64, device="meta")

        def f(w, x):
            h = x
            whole = gather_tree(w)
            for k in layers:
                h = h @ whole[k]
            return h

        _, acct = analyze_step(f, w, x)
        print(json.dumps(acct.to_dict()))
    """)
    import json
    acct = json.loads(out.strip().splitlines()[-1])
    assert sum(acct["count_by_type"].values()) >= 6, acct
    assert acct["count_by_type"] == {"all-gather": 6}
    assert acct["bytes_by_type"] == {"all-gather": 6 * 64 * 64 * 4}
    assert acct["flops"] >= 2 * 8 * 64 * 64 * 6 / 4
    assert acct["flops"] == 2 * 8 * 64 * 64 * 6


def _port_step(name: str, kind: str, **kw):
    """The port's step of the reduced ``name`` at SEQ x BATCH, unsharded,
    traced on ``meta`` (the kernels through their ``meta`` routes, the
    GEMMs ranked for the card)."""
    cfg = reduced(ARCHS[name])
    cell = ShapeCell("c", SEQ, BATCH, kind)
    if kind == "train":
        fn, (aval, _), (ins, _) = build_train_step(cfg, cell, donate=False)
        return analyze_step(fn, aval, ins, **kw)[1]
    params = init_model(cfg, 0, device="meta")
    ins = input_specs(cfg, cell)
    if kind == "prefill":
        return analyze_step(prefill_fn, cfg, params, tokens=ins["tokens"],
                            **kw)[1]
    return analyze_step(decode_fn, cfg, params, ins["cache"], ins["tokens"],
                        SEQ - 1, **kw)[1]


def _vjp_recompute(name: str) -> float:
    """The flops the K4/K5 plain VJPs recompute in a train step: each
    forward call of K4 and K5 is recomputed once, from its saved inputs,
    by ``FlashAttentionFunction.backward`` (``attention_ref``) and
    ``SSDFunction.backward`` (``ssd_chunked``) — the kernels' forward
    flops of one loss forward."""
    cfg = reduced(ARCHS[name])
    ins = input_specs(cfg, ShapeCell("c", SEQ, BATCH, "train"))
    with torch.no_grad():
        _, acct = analyze_step(loss_fn, cfg, init_model(cfg, 0,
                                                        device="meta"), ins)
    return sum(acct.kernel_flops.get(k, 0.0)
               for k in ("flash_attention", "ssd"))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_one_rank_flops_are_repros(name, kind):
    want = j_analyze_hlo(_j_step_hlo(name, kind)).flops
    acct = _port_step(name, kind)
    cfg = reduced(ARCHS[name])
    if kind == "train":
        # the VJPs' recomputed forward makes up the difference (1.5-3.6 %
        # at these widths); with it added, the attention archs are exact
        # and the SSD archs within 1 % (0.6-0.9 %: autograd and XLA
        # differentiate the chunked scan's products differently)
        extra = _vjp_recompute(name)
        assert extra > 0
        assert abs(acct.flops - (want + extra)) <= 0.01 * want, \
            (acct.flops, want, extra)
        if cfg.family not in ("ssm", "hybrid"):
            assert acct.flops == want + extra, (acct.flops, want, extra)
        assert acct.kernels.get("tiled_mm", 0) == 0   # grad-safe engine
    else:
        assert acct.flops == want, (acct.flops, want)
        # the card's kernels, K1 on every projection of the zoo
        assert acct.kernels["tiled_mm"] > 0
    if kind != "decode" and cfg.family in ("dense", "moe", "hybrid"):
        assert acct.kernels["flash_attention"] > 0
    if kind != "decode" and cfg.family in ("ssm", "hybrid"):
        assert acct.kernels["ssd"] > 0


def test_kernels_report_their_plain_formulations_flops():
    b, hq, hkv, s, d = 2, 4, 2, 48, 16
    q, k, v = _meta(b, hq, s, d), _meta(b, hkv, s, d), _meta(b, hkv, s, d)
    _, plain = analyze_step(attention_ref, q, k, v, causal=True)
    _, kern = analyze_step(fa_ops.flash_attention_cuda, q, k, v)
    assert kern.kernels == {"flash_attention": 1}
    assert kern.flops == plain.flops == 4 * b * hq * s * s * d
    bb, h, l, p, n, chunk = 2, 3, 64, 16, 16, 16
    args = (_meta(bb, h, l, p), _meta(bb, h, l), _meta(bb, l, n),
            _meta(bb, l, n))
    _, plain = analyze_step(ssd_ops.ssd_chunked, *args, chunk=chunk)
    _, kern = analyze_step(ssd_ops.ssd_cuda, *args, chunk=chunk)
    assert kern.kernels == {"ssd": 1}
    assert kern.flops == plain.flops == ssd_ops.ssd_flops(bb, h, l, p, n,
                                                          chunk)
    _, kern = analyze_step(tiled_ops.tiled_matmul, _meta(5, 7), _meta(7, 3))
    assert kern.flops == 2 * 5 * 7 * 3


def test_memory_of_a_chain_is_exact():
    """Storages made by the step, live until they die: views share their
    base's storage, an in-place write makes none, a cast is read at its
    source dtype; the results split into storages the step made and
    storages it was given."""
    n = 1000

    def chain(x):
        y = x + 1                   # n floats made
        z = y * 2                   # 2n live
        del y                       # n
        w = torch.cat([z, z])       # 3n live: the peak
        w.add_(1)                   # in place: nothing made
        v = w.view(2, n)            # a view: nothing made
        del z                       # 2n
        h = x.to(torch.bfloat16)    # a cast: 2n + n/2
        return v, x, h.sum()        # h dies; 4 bytes of sum

    x = _meta(n)
    (v, same, _), acct = analyze_step(chain, x)
    assert same is x
    assert acct.peak_bytes == 3 * n * 4
    assert acct.output_bytes == 2 * n * 4 + 2   # w, and a bf16 scalar
    assert acct.alias_bytes == n * 4
    # traffic in floats: add 2n, mul 2n, cat 4n (z twice in, 2n out),
    # add_ 4n (in and out); the sum reads h at its source dtype (n
    # floats) and writes 2 bytes; the cast, the view and the allocations
    # move nothing
    assert acct.hbm_bytes == 4 * (2 * n + 2 * n + 4 * n + 4 * n + n) + 2


def test_peak_is_itemized_by_phase_and_origin():
    """The chain's kind of step with a backward and an optimizer span:
    every storage is booked to the phase that made it (an autograd node
    running: the backward; inside ``step_phase("optimizer")``: the
    optimizer) and to the op that made it; ``peak_by_origin`` is what is
    live at the peak, the largest groups first and the rest as
    ``other``, summing exactly to ``peak_bytes``; ``phase_peaks`` are the
    most bytes live while each phase made storages."""
    n = 1000

    def step(x, w):
        y = x * w                           # forward: n floats
        loss = (y * y).sum()                # forward: n, then 4 bytes
        del y
        g, = torch.autograd.grad(loss, w)   # backward: w's gradient
        with step_phase("optimizer"):
            small = [g[:k] + 1 for k in range(1, TOP_ORIGINS + 3)]
            big = torch.cat([g, g, g, g])   # 4n: the peak
            del big, small
        return g

    x, w = _meta(n), _meta(n).requires_grad_()
    g, acct = analyze_step(step, x, w)
    assert g.shape == (n,)
    assert acct.peak_phase == "optimizer"
    groups = acct.peak_by_origin
    assert sum(r["bytes"] for r in groups) == acct.peak_bytes
    assert groups[0] == {"phase": "optimizer", "origin": "aten.cat",
                         "shape": [4 * n], "dtype": "float32", "count": 1,
                         "bytes": 16 * n}
    named = {(r["phase"], r["origin"]): r for r in groups}
    grad = [r for r in groups if r["phase"] == "backward"]
    assert len(grad) == 1 and grad[0]["shape"] == [n]
    assert grad[0]["bytes"] == 4 * n and grad[0]["count"] == 1
    # twelve small sums, ten groups named: the rest is one "other"
    assert len(groups) == TOP_ORIGINS + 1
    assert groups[-1]["origin"] == "other" and groups[-1]["count"] >= 2
    assert ("forward", "aten.mul") not in named       # y and y*y died
    assert set(acct.phase_peaks) == {"forward", "backward", "optimizer"}
    assert acct.phase_peaks["optimizer"] == acct.peak_bytes
    assert 4 * n <= acct.phase_peaks["backward"] < acct.peak_bytes
    assert acct.phase_peaks["forward"] >= 8 * n       # y and y*y


def test_gathered_storages_are_booked_to_the_gather():
    """A collective's result buffers, and the concatenation of an
    all-gather's parts, are booked to the collective: on one rank of a
    fake group (a subprocess: the group is process-global)."""
    out = _run("""
        import json, torch
        from repro_torch.launch.dryrun import start_fake_group
        from repro_torch.launch.hlo_analysis import analyze_step
        from repro_torch.models.partition import _gather
        start_fake_group(4)
        x = torch.empty(8, 16, device="meta")
        _, acct = analyze_step(lambda t: _gather(t, 0, 4, None) * 2, x)
        print(json.dumps([acct.peak_by_origin, acct.peak_bytes]))
    """)
    groups, peak = json.loads(out.strip().splitlines()[-1])
    # the peak: the four parts and their concatenation (the product
    # comes once the parts have died, no higher)
    assert peak == 2 * 32 * 16 * 4
    assert sum(r["bytes"] for r in groups) == peak
    assert {(r["origin"], tuple(r["shape"]), r["count"])
            for r in groups} == {("all-gather", (8, 16), 4),
                                 ("all-gather", (32, 16), 1)}


# ---------------------------------------------------------------------------
# the meta routes
# ---------------------------------------------------------------------------

def _gemm_cases():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(6, 40, generator=g), torch.randn(40, 24, generator=g)
    bias = torch.randn(24, generator=g)
    qa = torch.randint(-128, 128, (6, 32), generator=g, dtype=torch.int8)
    qw = torch.randint(-128, 128, (32, 16), generator=g, dtype=torch.int8)
    ws = torch.rand(16, generator=g) + 0.5
    fa = [torch.randn(2, h, 16, 16, generator=g) for h in (4, 2, 2)]
    sd = (torch.randn(2, 3, 32, 16, generator=g),
          -torch.rand(2, 3, 32, generator=g),
          torch.randn(2, 32, 16, generator=g),
          torch.randn(2, 32, 16, generator=g))
    return {
        "tiled_mm": (tiled_ops.tiled_matmul, (a, b),
                     {"bias": bias, "activation": torch.relu}, 1),
        "tiled_mm_bf16": (tiled_ops.tiled_matmul,
                          (a.bfloat16(), b.bfloat16()),
                          {"activation": torch.tanh,
                           "out_dtype": torch.float32}, 1),
        "vpu_mm": (vpu_ops.vpu_matmul, (a, b), {"bias": bias}, 1),
        "qmm": (qmm_ops.qmm_matmul, (qa, qw, ws),
                {"act_scale": 0.5, "bias": ws, "out_dtype": torch.bfloat16},
                1),
        "qmm_raw": (qmm_ops.qmm_matmul, (qa, qw, ws),
                    {"fuse_dequant": False}, 1),
        "flash_attention": (fa_ops.flash_attention_cuda, tuple(fa),
                            {"causal": True}, 1),
        "ssd": (ssd_ops.ssd_cuda, sd, {"chunk": 16}, 2),
    }


def _launches() -> dict:
    return {"tiled_mm": tiled_ops.tiled_matmul.launches,
            "vpu_mm": vpu_ops.vpu_matmul.launches,
            "qmm": qmm_ops.qmm_matmul.launches,
            "flash_attention": fa_ops.flash_attention_cuda.launches,
            "ssd": ssd_ops.ssd_cuda.launches}


@pytest.mark.parametrize("case", list(_gemm_cases()))
def test_meta_route_mirrors_the_plain_version(case):
    fn, args, kw, n_out = _gemm_cases()[case]
    before = _launches()
    want = fn(*args, **kw)                      # CPU: the plain version
    meta_args = tuple(t.to("meta") for t in args)
    meta_kw = {k: v.to("meta") if torch.is_tensor(v) else v
               for k, v in kw.items()}
    got = fn(*meta_args, **meta_kw)             # no listener: reports none
    got2, acct = analyze_step(fn, *meta_args, **meta_kw)
    want = want if n_out > 1 else (want,)
    for res in (got, got2):
        res = res if n_out > 1 else (res,)
        assert [(t.shape, t.dtype, t.device.type) for t in res] == \
            [(t.shape, t.dtype, "meta") for t in want]
    assert _launches() == before                # nothing launched
    kernel = case.split("_bf16")[0].split("_raw")[0]
    assert acct.kernels == {kernel: 1}
    assert acct.flops > 0 and acct.hbm_bytes > 0
    if kernel == "tiled_mm":
        path = "wgmma" if case.endswith("bf16") else "ffma"
        assert acct.kernel_paths == {"tiled_mm": {path: 1}}
    if kernel == "qmm":
        assert acct.kernel_paths == {"qmm": {"async": 1}}


def test_meta_kernel_shapes_are_checked_as_on_the_card():
    # the kernels' own limits hold on meta as on the card: K4's head dims
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_cuda(_meta(1, 2, 8, 24), _meta(1, 2, 8, 24),
                                    _meta(1, 2, 8, 24))
    with pytest.raises(ValueError, match="kernel takes"):
        ssd_ops.ssd_cuda(_meta(1, 2, 16, 8), _meta(1, 2, 16),
                         _meta(1, 16, 8), _meta(1, 16, 8), chunk=16)
    # a meta operand off a 16-byte boundary takes qmm's shift path
    qa = torch.empty(4 * 32 + 1, dtype=torch.int8,
                     device="meta")[1:].view(4, 32)
    _, acct = analyze_step(qmm_ops.qmm_matmul, qa,
                           _meta(32, 16, dtype=torch.int8), _meta(16))
    assert acct.kernel_paths == {"qmm": {"shift": 1}}


def test_meta_gemms_rank_for_the_card_only_in_a_trace():
    a, b = _meta(16, 32), _meta(32, 8)
    tiled = get_engine("cuda-tiled").telemetry.gemms
    torch_eng = get_engine("torch").telemetry.gemms
    synergy_matmul(a, b)                        # meta, untraced: torch
    assert get_engine("torch").telemetry.gemms == torch_eng + 1
    _, acct = analyze_step(synergy_matmul, a, b)
    assert acct.kernels == {"tiled_mm": 1}      # traced: the card's K1
    assert get_engine("cuda-tiled").telemetry.gemms == tiled + 1
    # CPU tensors rank as they always did, traced or not
    x, y = torch.randn(16, 32), torch.randn(32, 8)
    _, acct = analyze_step(synergy_matmul, x, y)
    assert acct.kernels == {}
    assert get_engine("torch").telemetry.gemms == torch_eng + 2
    np.testing.assert_allclose(synergy_matmul(x, y).numpy(),
                               (x @ y).numpy(), rtol=1e-5, atol=1e-5)
