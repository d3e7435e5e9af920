"""Flash attention (K4) in the port against repro, on the CPU: the kernel's
wrapper (which runs its plain version on CPU tensors), the plain version,
the online-softmax torch path ('flash_torch') and the 'attention_scores'
variants, each on the same numpy inputs as repro's Pallas kernel
(interpret mode), its flash_xla scan path and its oracle.  Tolerance 2e-5
(tests/test_flash_attention.py), bf16 5e-2.  GQA, causal and full,
ragged S/Sk, cross attention and the zoo's head dims."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (attention_ref as j_attention_ref,
                                           flash_attention as j_flash,
                                           flash_attention_pallas)
from repro.models.attention import _scores_engine as j_scores
from repro.models.attention import flash_attention_xla
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import (HEAD_DIMS, attention_ref,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import check_kernel_shape
from repro_torch.models.attention import _scores_engine, flash_attention_torch

TOL = 2e-5


def _qkv(b, hq, hkv, s, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_wrapper_matches_pallas(hq, hkv, causal):
    q, k, v = _qkv(2, hq, hkv, 128, 128, 64)
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(*_t(q, k, v), causal=causal)
    assert flash_attention_cuda.launches == before     # CPU: plain version
    _close(o, flash_attention_pallas(q, k, v, causal=causal, blk_q=64,
                                     blk_k=64, interpret=True))
    _close(o, j_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("d", [64, 80, 112, 128, 256, 16])
def test_zoo_head_dims(d):
    q, k, v = _qkv(1, 4, 2, 64, 64, d, seed=d)
    _close(attention_ref(*_t(q, k, v)),
           flash_attention_pallas(q, k, v, blk_q=32, blk_k=32,
                                  interpret=True))


@pytest.mark.parametrize("s,sk", [(128, 128), (100, 1500), (257, 64),
                                  (64, 256)])
def test_flash_torch_matches_flash_xla(s, sk):
    q, k, v = _qkv(2, 4, 4, s, sk, 32, seed=1)
    o = flash_attention_torch(*_t(q, k, v), causal=False, blk_q=64,
                              blk_k=128)
    _close(o, flash_attention_xla(q, k, v, causal=False, blk_q=64,
                                  blk_k=128))
    _close(o, j_attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("s", [64, 200])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_flash_torch_causal_ragged_gqa(s, hq, hkv):
    q, k, v = _qkv(2, hq, hkv, s, s, 16, seed=s + hq)
    o = flash_attention_torch(*_t(q, k, v), causal=True, blk_q=32, blk_k=64)
    _close(o, flash_attention_xla(q, k, v, causal=True, blk_q=32, blk_k=64))
    _close(attention_ref(*_t(q, k, v), causal=True),
           j_attention_ref(q, k, v, causal=True))


@pytest.mark.parametrize("impl,j_impl", [("cuda", "pallas"),
                                         ("torch", "xla")])
def test_flash_attention_op_variants(impl, j_impl):
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=4)
    _close(flash_attention(*_t(q, k, v), causal=True, impl=impl),
           j_flash(q, k, v, causal=True, blk_q=32, blk_k=32, impl=j_impl))


@pytest.mark.parametrize("impl,j_impl", [("cuda", "pallas"),
                                         ("flash_torch", "flash_xla"),
                                         ("ref", "ref")])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_scores_variants(impl, j_impl, causal):
    q, k, v = _qkv(2, 4, 4, 128, 128, 16, seed=5)
    _close(_scores_engine(*_t(q, k, v), causal=causal, impl=impl,
                          blk_q=64, blk_k=64),
           j_scores(q, k, v, causal=causal, impl=j_impl, blk_q=64,
                    blk_k=64))


@pytest.mark.parametrize("s,sk", [(150, 150), (16, 150)])
def test_whisper_encoder_and_cross(s, sk):
    """Non-causal: the encoder's square ragged S and cross-attention's
    S != Sk (repro's encoder is 1500 frames; a tenth of it here)."""
    q, k, v = _qkv(2, 4, 4, s, sk, 16, seed=sk + s)
    want = j_attention_ref(q, k, v, causal=False)
    _close(flash_attention_cuda(*_t(q, k, v), causal=False), want)
    _close(flash_attention_torch(*_t(q, k, v), causal=False, blk_q=64,
                                 blk_k=64), want)


def test_causal_first_token_ignores_future():
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=2)
    o = flash_attention(*_t(q, k, v), causal=True, impl="cuda")
    np.testing.assert_allclose(o[:, :, 0].numpy(), v[:, :, 0], rtol=1e-4,
                               atol=1e-4)


def test_bf16():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    o = flash_attention_cuda(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    r = flash_attention_pallas(jq, jk, jv, causal=True, blk_q=64, blk_k=64,
                               interpret=True)
    _close(o, r, tol=5e-2)
    _close(flash_attention_torch(tq, tk, tv, causal=True, blk_q=64,
                                 blk_k=64), r, tol=5e-2)


def test_wrapper_checks():
    q, k, v = _t(*_qkv(1, 4, 2, 64, 64, 16))
    with pytest.raises(ValueError, match="S == Sk"):
        flash_attention_cuda(q, k[:, :, :32].contiguous(),
                             v[:, :, :32].contiguous(), causal=True)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.to(torch.bfloat16), v, causal=False)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, causal=False)
    with pytest.raises(ValueError):
        flash_attention_cuda(q[0], k, v, causal=False)
    with pytest.raises(ValueError, match="Hkv"):
        flash_attention_cuda(q, *_t(*_qkv(1, 3, 3, 64, 64, 16))[1:],
                             causal=False)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_matches_repro(pos):
    """One-token decode against a KV cache, the new token written at
    ``pos`` (the port writes in place, repro returns new caches)."""
    from repro.models.attention import (decode_attention as
                                        j_decode_attention)
    from repro.models.attention import init_attention as j_init_attention
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.params import lm_params_from_jax
    jp = j_init_attention(jax.random.key(pos), 32, 4, 2, 8)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
              for _ in range(2))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    jy, jk, jv = j_decode_attention(jp, x, kc, vc, pos, **kw)
    y, k, v = decode_attention(tp, *_t(x, kc, vc), pos, **kw)
    for port, ref in ((y, jy), (k, jk), (v, jv)):
        _close(port, ref)


def _zoo_head_dims():
    """Head dims of the attention archs at published widths and reduced."""
    cfgs = [c for c in ARCHS.values() if not c.is_attention_free]
    return sorted({c.resolved_head_dim for c in cfgs}
                  | {reduced(c).resolved_head_dim for c in cfgs})


@pytest.mark.parametrize("d", _zoo_head_dims())
def test_kernel_is_built_for_every_zoo_head_dim(d):
    """The card's kernel takes the head dim of every attention arch, at
    published widths and ``reduced()`` (16): the check the CUDA path runs
    before it launches passes."""
    assert d in HEAD_DIMS
    check_kernel_shape(2, 4, 64, 64, d)


@pytest.mark.parametrize("d", [8, 32, 48, 96, 100, 512])
def test_kernel_shape_check_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="head dim"):
        check_kernel_shape(2, 4, 64, 64, d)


def test_kernel_shape_check_refuses_a_grid_overflow():
    with pytest.raises(ValueError, match="grid"):
        check_kernel_shape(70000, 4, 64, 64, 16)
