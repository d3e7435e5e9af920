"""The pod-scale pipeline and local SGD of the port on gloo ranks on the
CPU (``spawn`` of test_torch_mesh.py), against repro.

* ``gpipe_spmd`` over 4 ranks (4 stages, 8 microbatches of (2, 16),
  ``tanh(x @ p)``): the last stage's outputs within 2e-5 of repro's
  ``gpipe_reference`` on the same numpy inputs and equal to the port's
  own ``gpipe_reference``; every other stage returns zeros (repro's
  test_gpipe_spmd_matches_reference).
* ``build_pp_forward`` on a (pod 4, model 2) mesh with repro's reduced
  granite (4 layers, d 32, 2 heads, d_ff 64, vocab 128; 6 microbatches of
  1 x 8 tokens), repro's parameters carried across: within 3e-4 of
  repro's sequential ``_scan_blocks`` (repro's
  test_pp_mode_matches_sequential); a stream of another length than the
  pipeline was built for is refused before any rank is addressed.
* ``sync_pods_compressed`` on a (pod 2, data 2) mesh with the inputs of
  repro's test_crosspod_sync_compressed_matches_mean: the new parameters
  and error feedback BITWISE equal to repro's ``sync_pods_compressed``
  under ``shard_map`` on 4 host devices (a subprocess), and within 2e-2
  of the plain mean.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.core.pipeline import gpipe_reference as j_gpipe_reference
from repro.models import init_model as j_init_model
from repro.models.transformer import _attn_block_fwd as j_block
from repro.models.transformer import _scan_blocks as j_scan_blocks
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import gpipe_reference
from repro_torch.launch.pipeline_mode import build_pp_forward
from repro_torch.models import lm_params_from_jax
from test_torch_mesh import SRC, rank_result, spawn

S, M = 4, 8                       # gpipe: stages, microbatches
GPIPE_TOL, PP_TOL, SGD_MEAN_TOL = 2e-5, 3e-4, 2e-2
PP_KW = dict(n_layers=4, d_model=32, n_heads=2, d_ff=64, vocab=128)
PP_M, PP_B, PP_S = 6, 1, 8

_FOUR = '''
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core import gpipe_spmd
from repro_torch.runtime import sync_pods_compressed

inp = load("inputs")
stages = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
out = gpipe_spmd(lambda p, x: torch.tanh(x @ p),
                 inp["params"][stages.get_local_rank("stage")], inp["mbs"],
                 mesh=stages, axis_name="stage", num_stages=4)
pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
pod = pods.get_local_rank("pod")
mine = lambda k: {"w": inp[k][pod]}
new_p, new_a, new_e = sync_pods_compressed(
    mine("sgd_params"), mine("sgd_anchor"), mine("sgd_err"), mesh=pods)
assert new_a is new_p
save("four", {"gpipe": out, "sgd": (new_p["w"], new_e["w"])})
'''

_EIGHT = '''
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.pipeline_mode import build_pp_forward, split_stages

inp = load("pp")
cfg = reduced(ARCHS["granite-3-2b"], **inp["kw"])
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod", "model"))
fn, stages = build_pp_forward(cfg, mesh, stage_axis="pod",
                              microbatches=inp["mbs"].shape[0])
assert stages == 4
save("pp", fn(split_stages(inp["params"], 4), inp["mbs"]))
'''

_REPRO_SGD = '''
import jax, jax.numpy as jnp, numpy as np, sys
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.runtime import sync_pods_compressed
inp = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("pod", "data"))


def body(p, a, e):
    p, a, e = ({"w": t["w"][0]} for t in (p, a, e))
    new_p, _, new_e = sync_pods_compressed(p, a, e, axis_name="pod")
    return new_p["w"][None], new_e["w"][None]


f = shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod"), P("pod")),
              out_specs=(P("pod"), P("pod")))
new_p, new_e = f(*({"w": jnp.asarray(inp[k])}
                   for k in ("params", "anchor", "err")))
np.savez(sys.argv[2], params=np.asarray(new_p), err=np.asarray(new_e))
'''


def _sgd_inputs():
    """repro's test_crosspod_sync_compressed_matches_mean inputs."""
    anchor = np.asarray(jax.random.normal(jax.random.key(0), (2, 64)))
    drift = np.stack([np.ones(64) * 0.1, -np.ones(64) * 0.3]).astype(
        np.float32)
    params = np.asarray(jnp.asarray(anchor) + jnp.asarray(drift))
    return params, anchor, np.zeros((2, 64), np.float32), drift


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = tmp_path_factory.mktemp("four")
    rng = np.random.default_rng(0)
    params = (rng.standard_normal((S, 16, 16)) * 0.3).astype(np.float32)
    mbs = rng.standard_normal((M, 2, 16)).astype(np.float32)
    sp, sa, se, drift = _sgd_inputs()
    torch.save({"params": torch.tensor(params), "mbs": torch.tensor(mbs),
                "sgd_params": torch.tensor(sp),
                "sgd_anchor": torch.tensor(sa),
                "sgd_err": torch.tensor(se)}, d / "inputs.pt")
    spawn(d, 4, _FOUR)
    return d, params, mbs, (sp, sa, se, drift)


def test_gpipe_spmd_matches_reference(four):
    d, params, mbs, _ = four
    ref = np.asarray(j_gpipe_reference(lambda p, x: jnp.tanh(x @ p),
                                       list(jnp.asarray(params)),
                                       jnp.asarray(mbs)))
    own = gpipe_reference(lambda p, x: torch.tanh(x @ p),
                          list(torch.tensor(params)), torch.tensor(mbs))
    outs = [rank_result(d, "four", r)["gpipe"] for r in range(S)]
    np.testing.assert_allclose(outs[-1].numpy(), ref, rtol=GPIPE_TOL,
                               atol=GPIPE_TOL)
    assert torch.equal(outs[-1], own)
    for out in outs[:-1]:
        assert out.shape == own.shape and not out.any()


def test_sync_pods_compressed_is_bitwise_repro_under_shard_map(four,
                                                                tmp_path):
    d, _, _, (sp, sa, se, drift) = four
    src = tmp_path / "in.npz"
    np.savez(src, params=sp, anchor=sa, err=se)
    res = subprocess.run(
        [sys.executable, "-c", _REPRO_SGD, str(src), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    mean = sa + drift.mean(axis=0, keepdims=True)
    for rank in range(4):
        new_p, new_e = rank_result(d, "four", rank)["sgd"]
        pod = rank // 2                   # mesh order: pod, data
        np.testing.assert_array_equal(new_p.numpy(), want["params"][pod])
        np.testing.assert_array_equal(new_e.numpy(), want["err"][pod])
        np.testing.assert_allclose(new_p.numpy(), mean[pod],
                                   atol=SGD_MEAN_TOL)


def test_pp_mode_matches_sequential(tmp_path):
    jcfg = j_reduced(J_ARCHS["granite-3-2b"], **PP_KW)
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: j_init_model(jcfg, k))(
        jax.random.key(0)))
    mbs = np.random.default_rng(1).standard_normal(
        (PP_M, PP_B, PP_S, jcfg.d_model)).astype(np.float32)
    torch.save({"params": lm_params_from_jax(jp, device="cpu"),
                "mbs": torch.tensor(mbs), "kw": PP_KW}, tmp_path / "pp.pt")
    spawn(tmp_path, 8, _EIGHT)
    body = lambda p, h: j_block(jcfg, p, h)
    ref = np.stack([np.asarray(j_scan_blocks(body, jnp.asarray(mbs[i]),
                                             jp["blocks"], False))
                    for i in range(PP_M)])
    for rank in range(8):
        out = rank_result(tmp_path, "pp", rank)
        assert out.shape == (4 * PP_M, PP_B, PP_S, jcfg.d_model)
        out = out.reshape(4, PP_M, PP_B, PP_S, jcfg.d_model)
        np.testing.assert_allclose(out[-1].numpy(), ref, rtol=PP_TOL,
                                   atol=PP_TOL)


def test_pp_forward_refuses_a_stream_of_another_length():
    """``build_pp_forward(..., microbatches=6)`` given 5 microbatches
    raises before it touches the mesh's ranks (a stand-in mesh here)."""
    cfg = reduced(ARCHS["granite-3-2b"], n_layers=4)
    mesh = SimpleNamespace(shape=(4, 2), mesh_dim_names=("pod", "model"))
    fn, stages = build_pp_forward(cfg, mesh, stage_axis="pod",
                                  microbatches=6)
    assert stages == 4
    with pytest.raises(ValueError, match="built for 6 microbatches, given 5"):
        fn({}, torch.zeros(5, 1, 8, cfg.d_model))
