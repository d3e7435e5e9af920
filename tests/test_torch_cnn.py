"""The port's paper-CNN forward against repro's, for all seven Table-2
networks: the same params (drawn by repro, handed over as numpy), the same
input, logits within fp32 tolerance (1e-4: five layers summed in another
order), and the same GEMM decomposition in the SynergyTrace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core.synergy_mm import SynergyTrace as JaxTrace
from repro.models import cnn as jax_cnn
from repro_torch.configs import PAPER_CNNS
from repro_torch.core.synergy_mm import SynergyTrace
from repro_torch.engines import ENGINE_NAME_MAP
from repro_torch.models import cnn

TOL = 1e-4


def _inputs(name, batch=2, seed=1):
    jcfg = JAX_CNNS[name]
    jparams = jax_cnn.init_cnn(jcfg, jax.random.key(0))
    x = np.random.default_rng(seed).standard_normal(
        (batch, jcfg.input_hw, jcfg.input_hw, jcfg.cin)).astype(np.float32)
    params = cnn.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, x, params


def _jobsets(tr):
    return [(js.name, js.m, js.n, js.k, js.ts_m, js.ts_n, js.ts_k)
            for js in tr.jobsets]


@pytest.mark.parametrize("name", sorted(PAPER_CNNS))
def test_forward_matches_reference(name):
    cfg = PAPER_CNNS[name]
    jcfg, jparams, x, params = _inputs(name)
    jtr = JaxTrace()
    with jtr.activate():
        want = jax.jit(lambda p, xx: jax_cnn.cnn_forward(jcfg, p, xx))(
            jparams, jnp.asarray(x))
    tr = SynergyTrace()
    with tr.activate():
        got = cnn.cnn_forward(cfg, params, torch.from_numpy(x), device="cpu")
    assert got.shape == (2, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    n_conv = sum(1 for s in cfg.layers if s[0] == "conv")
    n_fc = sum(1 for s in cfg.layers if s[0] == "fc")
    assert len(tr.jobsets) == n_conv + n_fc
    assert _jobsets(tr) == _jobsets(jtr)
    assert ({ENGINE_NAME_MAP[k]: v.gemms for k, v in jtr.engine_stats.items()}
            == {k: v.gemms for k, v in tr.engine_stats.items()})


@pytest.mark.parametrize("name", sorted(PAPER_CNNS))
def test_flops_and_conv_jobsets_equal_reference(name):
    cfg, jcfg = PAPER_CNNS[name], JAX_CNNS[name]
    assert cfg == cnn.CNNConfig(**{f: getattr(jcfg, f) for f in (
        "name", "input_hw", "cin", "layers", "num_classes", "tile")})
    assert cnn.cnn_flops_per_frame(cfg) == jax_cnn.cnn_flops_per_frame(jcfg)
    for frames, tile in ((1, None), (8, (16, 32, 16))):
        ours = [(i, js.name, js.m, js.n, js.k, js.num_jobs)
                for i, js in cnn.conv_jobsets(cfg, frames, tile=tile)]
        theirs = [(i, js.name, js.m, js.n, js.k, js.num_jobs)
                  for i, js in jax_cnn.conv_jobsets(jcfg, frames, tile=tile)]
        assert ours == theirs


def test_kernel_engine_pin_matches_pallas_pin():
    """Pinning the tile engine: the port's CUDA engine runs its plain
    version on CPU tensors, repro's Pallas engine its interpreter."""
    name = "MNIST"
    jcfg, jparams, x, params = _inputs(name, seed=2)
    want = jax_cnn.cnn_forward(jcfg, jparams, jnp.asarray(x),
                               engine="pallas")
    got = cnn.cnn_forward(PAPER_CNNS[name], params, torch.from_numpy(x),
                          engine=ENGINE_NAME_MAP["pallas"], device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (5, 4)])
def test_maxpool_crops_odd_edges_like_reference(hw):
    x = np.random.default_rng(3).standard_normal((2, *hw, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        cnn.maxpool2d(torch.from_numpy(x), 2).numpy(),
        np.asarray(jax_cnn.maxpool2d(jnp.asarray(x), 2)))


def test_init_cnn_keys_shapes_and_seed():
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    ours = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    theirs = jax_cnn.init_cnn(JAX_CNNS[cfg.name], jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in ours.values())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = PAPER_CNNS["MNIST"]
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, 28, 28, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.cnn_forward(cfg, params, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.init_cnn(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.params_from_jax({"fc0_b": np.zeros(3, np.float32)})
