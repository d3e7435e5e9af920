"""The CUDA kernels on the card: tiled_mm (K1) and vpu_mm (K3) against
their plain versions, K1's three paths (fp32 FFMA, bf16 wgmma + TMA, bf16
mma.sync for shapes TMA cannot read) each counted and present in its
SASS, row panels bit-stable on every path, K3 bitwise equal to K1 and
free of tensor-core instructions, the dispatcher routing CUDA tensors onto
K1, and the work-stealing runtime splitting GEMMs over both kernels with
results bitwise equal to the unsplit K1 GEMM.  K2 (qmm) against its plain
version (raw int32 bitwise, fused epilogue bitwise for none/relu), one
build for every activation scale, quantization on the card bitwise the
CPU's, and the runtime's int32 split bitwise a one-worker split.  The
redesigns of K2 (int8 on the tensor cores, two paths by alignment) and K3
(tiles by shape) at their tile borders, with -128/127 operands and row
panels off every 16-byte boundary; K2's SASS holds IMMA and no IDP.  K4
(flash_attention) and K5 (ssd) against their plain versions at the zoo's
head dims (and the reduced configs' 16), GQA, ragged and cross shapes;
a narrow zamba2 whose prefill on the card launches both and matches the
CPU, and whose decode launches neither and reproduces the forward; the
reduced zamba2 and mamba2-130m prefilling on the card.  The inter-frame
pipeline with stages pinned to K1 and K3 bitwise the dispatcher's logits,
and CIFAR_Alex+ wave graphs over K1 + K3 bitwise the dispatcher's conv
front-end, with a graph cancel draining queued panels on the card.  The
continuous-batching server over K1 + K3 on the card: the CPU's tokens,
batched decode bitwise per-slot, decode GEMMs within 1e-5·sqrt(k) of the
CPU's.  Durable serving: card tensors (fp32, bf16) through the
Checkpointer bitwise, and the reduced granite server crashed and restored
on the card giving the CPU's uninterrupted tokens.  Training: K4's and
K5's backward (their autograd Functions) against autograd of the plain
versions, and two train steps of the reduced zamba2 on the card against
the CPU; Adafactor taken slice by slice on the card, and two steps of a
reduced kimi-k2 (MoE, Adafactor) against the CPU.

Every test here needs a card (marker ``requires_cuda``) and skips without
one.  On a machine with a card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import importlib.util
import math
import threading
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, PAPER_CNNS, reduced
from repro_torch.core import ThreadedPipeline
from repro_torch.core.job import JobSet
from repro_torch.core.synergy_mm import SynergyTrace, synergy_matmul
from repro_torch.engines import Engine, get_engine
from repro_torch.kernels.common.build import sass_opcodes
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_cuda,
                                                 flash_attention_library)
from repro_torch.kernels.qmm import qmm_library, qmm_matmul, qmm_ref
from repro_torch.kernels.ssd import ssd, ssd_cuda
from repro_torch.kernels.ssd.ref import ssd_witness
from repro_torch.kernels.ssd.ssd import SSD_SHAPES
from repro_torch.kernels.tiled_mm import (PATHS, ffma_chain_ref,
                                          tiled_matmul, tiled_mm_library,
                                          tiled_mm_ref)
from repro_torch.kernels.vpu_mm import vpu_matmul, vpu_mm_library, vpu_mm_ref
from repro_torch.models import (decode_fn, init_cache, init_model,
                                lm_forward, prefill_fn)
from repro_torch.models.cnn import cnn_forward, conv_jobsets, init_cnn
from repro_torch.quant import (QuantizedEngine, quantize_weights, rel_err)
from repro_torch.quant.act import one_shot_act_scale, quantize_activations
from repro_torch.core.serving import SynergyServer
from repro_torch.soc import (CrashPlan, Durability, FaultPlan, FaultSpec,
                             FaultyEngine, GraphCancelled, RetryPolicy,
                             SimulatedCrash, SynergyRuntime, wrap_pool)

POOL = ["cuda-tiled", "neon-vpu"]

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _rand(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, device="cuda", generator=g).to(dtype)


@pytest.mark.parametrize("act", [None, torch.relu, F.silu, torch.tanh],
                         ids=["none", "relu", "silu", "unfused-tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(70, 45, 33), (1, 257, 129),
                                   (130, 1, 31), (256, 128, 2048)])
def test_kernel_matches_plain(cuda, shape, dtype, act):
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    a, b = _rand(g, m, k, dtype=dtype), _rand(g, k, n, dtype=dtype)
    bias = _rand(g, n)
    before = tiled_matmul.launches
    y = tiled_matmul(a, b, bias=bias, activation=act)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    tol = 1e-5 * max(1.0, math.sqrt(k)) if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(
        y.float(), tiled_mm_ref(a, b, bias=bias, activation=act).float(),
        rtol=tol, atol=tol)


def test_row_panel_is_bitwise_equal_to_the_whole_gemm(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    a, b, bias = _rand(g, 1000, 300), _rand(g, 300, 70), _rand(g, 70)
    whole = tiled_matmul(a, b, bias=bias, activation=torch.relu)
    for lo, hi in ((0, 1), (3, 67), (500, 1000)):
        panel = tiled_matmul(a[lo:hi].contiguous(), b, bias=bias,
                             activation=torch.relu)
        assert torch.equal(panel, whole[lo:hi])


@pytest.mark.parametrize("act", [None, torch.relu, F.silu],
                         ids=["none", "relu", "silu"])
@pytest.mark.parametrize("shape", [(4096, 2560, 2560), (4096, 20480, 2560),
                                   (4, 2560, 10240), (70, 45, 33),
                                   (1, 257, 129), (130, 1, 31)])
def test_bf16_gemm_takes_its_path_and_matches_plain(cuda, shape, act):
    """zamba2's GEMMs (aligned: wgmma + TMA) and the ragged shapes
    (mma.sync) within 3e-2 of the plain version, each counted on its
    path."""
    m, n, k = shape
    path = "wgmma" if n % 8 == 0 and k % 8 == 0 else "mma"
    g = torch.Generator(device=cuda).manual_seed(16)
    a = _rand(g, m, k, dtype=torch.bfloat16)
    b = _rand(g, k, n, dtype=torch.bfloat16)
    bias = _rand(g, n)
    before = dict(tiled_matmul.launches_by_path)
    y = tiled_matmul(a, b, bias=bias, activation=act)
    torch.cuda.synchronize()
    assert {p: c - before[p] for p, c in tiled_matmul.launches_by_path.items()} \
        == {p: int(p == path) for p in PATHS}
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    torch.testing.assert_close(
        y.float(), tiled_mm_ref(a, b, bias=bias, activation=act).float(),
        rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [(1000, 256, 320), (300, 45, 33)],
                         ids=["wgmma", "mma"])
def test_bf16_row_panel_is_bitwise_equal_to_the_whole_gemm(cuda, shape):
    """An output's bits depend on its row of A, on B and on k, never on m
    or on where the row sits in a tile: row panels, m = 1 against m = 4,
    and an A that starts off a 16-byte boundary (copied for TMA)."""
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(17)
    a = _rand(g, m, k, dtype=torch.bfloat16)
    b = _rand(g, k, n, dtype=torch.bfloat16)
    bias = _rand(g, n)
    whole = tiled_matmul(a, b, bias=bias, activation=torch.relu)
    for lo, hi in ((0, 1), (0, 4), (3, 67), (m // 2, m)):
        panel = tiled_matmul(a[lo:hi].contiguous(), b, bias=bias,
                             activation=torch.relu)
        assert torch.equal(panel, whole[lo:hi])
    one = tiled_matmul(a[1:2].contiguous(), b)
    four = tiled_matmul(a[1:5].contiguous(), b)
    assert torch.equal(one, four[:1])
    flat = torch.empty(m * k + 3, device=cuda, dtype=torch.bfloat16)
    view = flat[3:].view(m, k)
    view.copy_(a)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(tiled_matmul(view, b, bias=bias,
                                    activation=torch.relu), whole)


def test_fp32_gemms_take_the_ffma_path(cuda):
    g = torch.Generator(device=cuda).manual_seed(18)
    before = dict(tiled_matmul.launches_by_path)
    for m, n, k in ((256, 128, 2048), (70, 45, 33), (2048, 64, 75)):
        tiled_matmul(_rand(g, m, k), _rand(g, k, n))
    assert {p: c - before[p] for p, c in tiled_matmul.launches_by_path.items()} \
        == {"ffma": 3, "mma": 0, "wgmma": 0}


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("shape", [(32, 64, 1600), (33, 10, 75),
                                   (256, 128, 2048), (16384, 128, 1600),
                                   (16384, 64, 300)],
                         ids=["conv2-panel", "ragged", "fc6", "conv4",
                              "narrow"])
def test_fp32_bits_are_the_host_fmaf_chain(cuda, shape, bias):
    """K1's ``ffma`` path and K3, at each of their tiles (K1 32 x 64,
    128 x 128, 128 x 64; K3 16 x 8 and K1's two), give the bits of one
    fmaf per k in increasing k as the CPU emulates it, which depends on
    no CUDA source: the fixed witness of the fp32 bits, since the two
    kernels share their mainloop.  Rows at the first and last tiles'
    borders and in the middle are held."""
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(24)
    a, b, c = _rand(g, m, k), _rand(g, k, n), _rand(g, n)
    c = c if bias else None
    rows = sorted({*range(min(m, 40)), *range(max(0, m - 40), m),
                   *range(m // 2 - 3, m // 2 + 3)} & set(range(m)))
    for act in (None, torch.relu):
        want = ffma_chain_ref(a[rows], b, bias=c, activation=act)
        for kernel in (tiled_matmul, vpu_matmul):
            got = kernel(a, b, bias=c, activation=act)[rows].cpu()
            assert torch.equal(got, want), (kernel.__name__, act)


def test_tiled_mm_sass_holds_its_three_paths(cuda):
    ops = sass_opcodes(tiled_mm_library())
    assert ops["HGMMA"] > 0 and ops["HMMA"] > 0 and ops["FFMA"] > 0, \
        sorted(ops)


def test_flash_attention_sass_holds_tensor_core_products(cuda):
    ops = sass_opcodes(flash_attention_library())
    assert ops["HMMA"] > 0, sorted(ops)


def test_dispatcher_puts_cuda_gemms_on_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    a, b = _rand(g, 64, 48), _rand(g, 48, 32)
    tr = SynergyTrace()
    before = tiled_matmul.launches
    with tr.activate(), torch.inference_mode():
        synergy_matmul(a, b, tile=32)
    assert tiled_matmul.launches == before + 1
    assert set(tr.engine_stats) == {"cuda-tiled"}


def test_differentiated_gemm_avoids_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = _rand(g, 64, 48).requires_grad_()
    b = _rand(g, 48, 32)
    tr = SynergyTrace()
    before = tiled_matmul.launches
    with tr.activate():
        synergy_matmul(a, b, tile=32).sum().backward()
    assert tiled_matmul.launches == before
    assert set(tr.engine_stats) == {"torch"}
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())


def test_cnn_forward_on_the_card_matches_the_cpu(cuda):
    cfg = PAPER_CNNS["CIFAR_Darknet"]
    params = init_cnn(cfg, torch.Generator().manual_seed(4), device="cpu")
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    y_cpu = cnn_forward(cfg, params, x, device="cpu")
    y = cnn_forward(cfg, {k: v.to(cuda) for k, v in params.items()}, x)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- K3: vpu_mm

@pytest.mark.parametrize("act", [None, torch.relu, F.silu, torch.tanh],
                         ids=["none", "relu", "silu", "unfused-tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(70, 45, 33), (1, 257, 129),
                                   (130, 1, 31), (32, 64, 1600),
                                   (32, 10, 128)])
def test_vpu_kernel_matches_plain_and_tiled_mm(cuda, shape, dtype, act):
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    a, b = _rand(g, m, k, dtype=dtype), _rand(g, k, n, dtype=dtype)
    bias = _rand(g, n)
    before = vpu_matmul.launches
    y = vpu_matmul(a, b, bias=bias, activation=act)
    torch.cuda.synchronize()
    assert vpu_matmul.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    tol = 1e-5 * max(1.0, math.sqrt(k)) if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(
        y.float(), vpu_mm_ref(a, b, bias=bias, activation=act).float(),
        rtol=tol, atol=tol)
    if dtype == torch.float32:
        assert torch.equal(y, tiled_matmul(a, b, bias=bias, activation=act))


def test_vpu_kernel_uses_no_tensor_cores(cuda):
    ops = sass_opcodes(vpu_mm_library())
    assert ops["FFMA"] > 0
    assert not [op for op in ops if "MMA" in op], sorted(ops)


#: the borders of K2's and K3's tiles (32-row panels, 16 x 8 and 32 x 32
#: block tiles, k steps of 32 and 64): n and k crossed for each m
EDGE_NK = [(n, k) for n in (1, 10, 63, 65) for k in (1, 31, 33, 75)]


@pytest.mark.parametrize("m", [1, 31, 32, 33, 127, 129])
def test_vpu_kernel_at_tile_borders_is_bitwise_k1(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(19)
    for n, k in EDGE_NK:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = _rand(g, m, k, dtype=dtype), _rand(g, k, n, dtype=dtype)
            bias = _rand(g, n)
            y = vpu_matmul(a, b, bias=bias, activation=torch.relu)
            if dtype == torch.float32:
                assert torch.equal(y, tiled_matmul(a, b, bias=bias,
                                                   activation=torch.relu)), \
                    (m, n, k)
            else:
                torch.testing.assert_close(
                    y.float(), vpu_mm_ref(a, b, bias=bias,
                                          activation=torch.relu).float(),
                    rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [(32, 64, 75), (32, 64, 1600),
                                   (32, 128, 1600), (32, 10, 128),
                                   (256, 128, 2048), (2048, 64, 75)],
                         ids=["conv0-panel", "conv2-panel", "conv4-panel",
                              "fc7-panel", "fc6", "conv0-like"])
def test_vpu_kernel_tiles_are_bitwise_k1(cuda, shape):
    """Whichever tile K3 picks for a shape (the 16 x 8 panel tile, or
    K1's 128-row tiles), every fp32 output is K1's, and a row panel off
    every 16-byte boundary is the whole GEMM's rows."""
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(20)
    a, b, bias = _rand(g, m, k), _rand(g, k, n), _rand(g, n)
    for act in (None, torch.relu, F.silu):
        y = vpu_matmul(a, b, bias=bias, activation=act)
        assert torch.equal(y, tiled_matmul(a, b, bias=bias, activation=act))
    whole = vpu_matmul(a, b, bias=bias)
    lo = min(m - 1, 33)
    assert torch.equal(vpu_matmul(a[lo:], b, bias=bias), whole[lo:])


# --------------------------------------------- the runtime over K1 + K3

@pytest.mark.parametrize("affinity", POOL)
def test_runtime_split_is_bitwise_equal_to_one_k1_gemm(cuda, affinity):
    """All panels seeded onto one engine, the other steals: whichever
    kernel runs a panel, the merge is bitwise the unsplit K1 GEMM."""
    g = torch.Generator(device=cuda).manual_seed(7)
    m, n, k = 40 * 32 + 7, 64, 300
    a, b, bias = _rand(g, m, k), _rand(g, k, n), _rand(g, n)
    want = tiled_matmul(a, b, bias=bias, activation=torch.relu)
    js = JobSet.for_gemm(0, m, n, k, 32)
    launches = (tiled_matmul.launches, vpu_matmul.launches)
    with SynergyRuntime(POOL, device=cuda) as rt:
        fut = rt.submit_gemm(a, b, jobset=js, bias=bias,
                             activation=torch.relu, tile=(32, 32, 32),
                             affinity=affinity)
        y = fut.result(60)
        stats = rt.stats()
    assert torch.equal(y, want)
    assert fut.execution_counts == [1] * js.grid[0]
    k1 = tiled_matmul.launches - launches[0]
    k3 = vpu_matmul.launches - launches[1]
    assert k1 + k3 == js.grid[0]
    assert stats["total_jobs"] == js.num_jobs
    # a panel per engine: the seeded queue ran, and the idle one stole
    assert k1 > 0 and k3 > 0, (k1, k3, stats["total_steals"])


def test_cnn_forward_through_the_runtime_is_bitwise_the_k1_forward(cuda):
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    params = init_cnn(cfg, torch.Generator().manual_seed(8), device=cuda)
    x = torch.randn(16, 32, 32, 3, generator=torch.Generator().manual_seed(9))
    want = cnn_forward(cfg, params, x)
    tr = SynergyTrace()
    launches = (tiled_matmul.launches, vpu_matmul.launches)
    with SynergyRuntime(POOL, device=cuda) as rt, tr.activate():
        y = cnn_forward(cfg, params, x, runtime=rt)
    assert torch.equal(y, want)
    panels = sum(js.grid[0] for js in tr.jobsets)
    assert (tiled_matmul.launches - launches[0]
            + vpu_matmul.launches - launches[1]) == panels
    assert set(tr.engine_stats) <= set(POOL)


# ------------------------------------------------------------ K2: qmm

def _int8(g, *shape):
    return torch.randint(-128, 128, shape, device="cuda", generator=g,
                         dtype=torch.int8)


@pytest.mark.parametrize("shape", [(70, 45, 33), (1, 257, 129),
                                   (130, 10, 75), (32, 64, 1600),
                                   (256, 128, 2048)])
def test_qmm_raw_accumulator_is_bitwise_the_plain_version(cuda, shape):
    m, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(10)
    a, w = _int8(g, m, k), _int8(g, k, n)
    scale = torch.rand(1, n, device=cuda, generator=g)
    before = qmm_matmul.launches
    acc = qmm_matmul(a, w, scale, fuse_dequant=False)
    torch.cuda.synchronize()
    assert qmm_matmul.launches == before + 1
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc, qmm_ref(a, w, scale, fuse_dequant=False))


@pytest.mark.parametrize("act", [None, torch.relu, F.silu, torch.tanh],
                         ids=["none", "relu", "silu", "unfused-tanh"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_qmm_fused_epilogue_matches_the_plain_version(cuda, act, out_dtype,
                                                      with_bias):
    """Bitwise for none/relu (one rounding of acc * scale + bias on both
    sides); SiLU's expf differs from torch's: 2 ulp."""
    g = torch.Generator(device=cuda).manual_seed(11)
    m, n, k = 130, 70, 300
    a, w = _int8(g, m, k), _int8(g, k, n)
    w_scale = torch.rand(1, n, device=cuda, generator=g) * 1e-3
    bias = torch.randn(n, device=cuda, generator=g) if with_bias else None
    y = qmm_matmul(a, w, w_scale, act_scale=0.037, bias=bias, activation=act,
                   out_dtype=out_dtype)
    scale = w_scale * 0.037
    want = qmm_ref(a, w, scale, bias=bias, activation=act,
                   out_dtype=out_dtype)
    assert y.dtype == out_dtype
    if act in (None, torch.relu):
        assert torch.equal(y, want)
    else:
        ulp = torch.finfo(out_dtype).eps * want.float().abs().clamp_min(1e-30)
        assert bool(((y.float() - want.float()).abs() <= 2 * ulp).all())


@pytest.mark.parametrize("m", [1, 31, 32, 33, 127, 129])
def test_qmm_at_tile_borders_is_bitwise_the_plain_version(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(21)
    for n, k in EDGE_NK:
        a, w = _int8(g, m, k), _int8(g, k, n)
        w_scale = torch.rand(1, n, device=cuda, generator=g) * 1e-3
        bias = torch.randn(n, device=cuda, generator=g)
        assert torch.equal(qmm_matmul(a, w, w_scale, fuse_dequant=False),
                           qmm_ref(a, w, w_scale, fuse_dequant=False))
        for out_dtype in (torch.float32, torch.bfloat16):
            y = qmm_matmul(a, w, w_scale, act_scale=0.02, bias=bias,
                           activation=torch.relu, out_dtype=out_dtype)
            assert torch.equal(y, qmm_ref(a, w, w_scale * 0.02, bias=bias,
                                          activation=torch.relu,
                                          out_dtype=out_dtype)), (m, n, k)


@pytest.mark.parametrize("values", [(-128, -128), (-128, 127), (127, -128),
                                    (127, 127)])
@pytest.mark.parametrize("shape", [(33, 65, 75), (129, 64, 1600)],
                         ids=["shift", "async"])
def test_qmm_sums_saturated_operands_exactly(cuda, shape, values):
    m, n, k = shape
    va, vw = values
    a = torch.full((m, k), va, dtype=torch.int8, device=cuda)
    w = torch.full((k, n), vw, dtype=torch.int8, device=cuda)
    acc = qmm_matmul(a, w, torch.ones(n, device=cuda), fuse_dequant=False)
    assert bool((acc == va * vw * k).all())


def test_qmm_paths_follow_alignment_and_keep_the_bits(cuda):
    """k and n multiples of 16 on 16-byte boundaries take ``async``
    (so do the row panels of such a GEMM); a k = 75 GEMM and its row
    panels (bases at any byte) take ``shift``, and so does a W view off
    its boundary; every row panel is the whole GEMM's."""
    g = torch.Generator(device=cuda).manual_seed(22)
    counts = qmm_matmul.launches_by_path
    for k, path in ((75, "shift"), (1600, "async")):
        a, w = _int8(g, 4096, k), _int8(g, k, 64)
        scale = torch.rand(64, device=cuda, generator=g)
        before = dict(counts)
        whole = qmm_matmul(a, w, scale, fuse_dequant=False)
        for lo, hi in ((32, 64), (33, 66), (4095, 4096)):
            assert torch.equal(qmm_matmul(a[lo:hi], w, scale,
                                          fuse_dequant=False), whole[lo:hi])
        ran = {p: c - before[p] for p, c in counts.items()}
        assert ran == {"async": 4 * (path == "async"),
                       "shift": 4 * (path == "shift")}
    w_view = torch.empty(75 * 64 + 5, dtype=torch.int8, device=cuda)[5:]
    a, w = _int8(g, 300, 75), _int8(g, 75, 64)
    w_view = w_view.view(75, 64)
    w_view.copy_(w)
    assert torch.equal(qmm_matmul(a, w_view, scale, fuse_dequant=False),
                       qmm_matmul(a, w, scale, fuse_dequant=False))


def test_qmm_sass_holds_imma_and_no_dp4a(cuda):
    ops = sass_opcodes(qmm_library())
    assert ops["IMMA"] > 0 and ops["IDP"] == 0, sorted(ops)


def test_one_qmm_build_serves_every_scale(cuda):
    """Scales are operands: four activation scales, one library."""
    from repro_torch.kernels.common import build
    g = torch.Generator(device=cuda).manual_seed(12)
    a, w = _int8(g, 64, 96), _int8(g, 96, 40)
    w_scale = torch.rand(1, 40, device=cuda, generator=g)
    qmm_matmul(a, w, w_scale)                       # built and bound here
    lib, built = build._libs["qmm"], sorted(build._BUILD_DIR.glob("qmm-*.so"))
    for s in (0.011, 0.012, 0.013, 0.014):
        y = qmm_matmul(a, w, w_scale, act_scale=s)
        assert torch.equal(y, qmm_ref(a, w, w_scale * s))
    assert build._libs["qmm"] is lib
    assert sorted(build._BUILD_DIR.glob("qmm-*.so")) == built


def test_quantization_on_the_card_is_bitwise_the_cpu(cuda):
    g = torch.Generator().manual_seed(13)
    for shape, wscale in (((75, 64), 0.05), ((1600, 128), 0.03),
                          ((2048, 128), 0.02), ((128, 10), 0.1)):
        w = torch.randn(*shape, generator=g) * wscale
        q_cpu, q_card = quantize_weights(w), quantize_weights(w.to(cuda))
        assert torch.equal(q_card.q.cpu(), q_cpu.q)
        assert torch.equal(q_card.scale.cpu(), q_cpu.scale)
    a = torch.randn(4096, 1600, generator=g) * 3
    s = one_shot_act_scale(a)
    assert one_shot_act_scale(a.to(cuda)) == s
    for scale in (s, s / 3, 0.01):
        assert torch.equal(quantize_activations(a.to(cuda), scale).cpu(),
                           quantize_activations(a, scale))


@pytest.mark.parametrize("affinity", ["cuda-tiled", "cuda-tiled-int8"])
def test_runtime_int8_split_is_bitwise_the_one_worker_split(cuda, affinity):
    """All panels seeded onto one engine, the other steals: the merged
    int8 GEMM is bitwise a one-worker split from the same calibrator
    state, and every panel ran on K2 (K1 launched none)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    m, n, k = 40 * 32 + 7, 64, 300
    a = torch.randn(m, k, device=cuda, generator=g)
    b = torch.randn(k, n, device=cuda, generator=g) * 0.05
    bias = torch.randn(n, device=cuda, generator=g)
    js = JobSet.for_gemm(0, m, n, k, 32)
    q = QuantizedEngine(get_engine("cuda-tiled"), name="cuda-tiled-int8")
    outs = []
    for pool in (["cuda-tiled", q], [q]):
        q.calibrator.reset()
        before = (tiled_matmul.launches, qmm_matmul.launches)
        with SynergyRuntime(pool, device=cuda) as rt:
            fut = rt.submit_gemm(a, b, jobset=js, bias=bias,
                                 activation=torch.relu, tile=(32, 32, 32),
                                 affinity=affinity if len(pool) == 2
                                 else None, job_class="decode")
            outs.append(fut.result(60))
        assert tiled_matmul.launches == before[0]
        assert qmm_matmul.launches - before[1] == js.grid[0]
        if len(pool) == 2:
            assert set(fut.accounting) == {"cuda-tiled", "cuda-tiled-int8"}
    assert torch.equal(outs[0], outs[1])
    want = a @ b + bias
    assert rel_err(outs[0], torch.relu(want)) <= 0.05


# ------------------------------------------------ K4: flash_attention

def _fa_tol(sk, dtype):
    """fp32: 2e-5·sqrt(Sk) relative to max|ref| (the two sum Sk products
    in different orders); bf16: 3e-2."""
    return 2e-5 * math.sqrt(sk) if dtype == torch.float32 else 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 4, 4, 128, 128, 80, True), (2, 8, 2, 200, 200, 64, True),
    (1, 10, 5, 96, 96, 128, True), (1, 8, 1, 64, 64, 112, True),
    (1, 4, 4, 130, 130, 256, True), (2, 4, 4, 150, 150, 64, False),
    (2, 4, 4, 16, 150, 64, False), (1, 2, 2, 1, 1, 64, True),
    (2, 4, 4, 70, 70, 16, True), (2, 4, 2, 40, 90, 16, False)],
    ids=lambda c: "x".join(map(str, c[:6])) + ("-causal" if c[6] else ""))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    b, hq, hkv, s, sk, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q = _rand(g, b, hq, s, d, dtype=dtype)
    k = _rand(g, b, hkv, sk, d, dtype=dtype)
    v = _rand(g, b, hkv, sk, d, dtype=dtype)
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    r = attention_ref(q, k, v, causal=causal).float()
    assert rel_err(o, r) <= _fa_tol(sk, dtype)


# ------------------------------------------------------------ K5: ssd

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 3, 256, 64, 64, 128),
                                  (1, 2, 256, 64, 128, 128),
                                  (2, 2, 1000, 64, 64, 128),
                                  (1, 3, 192, 64, 64, 64),
                                  (1, 2, 16, 64, 64, 16),
                                  (2, 3, 48, 16, 16, 16)],
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    b, h, l, p, n, chunk = case
    g = torch.Generator(device=cuda).manual_seed(8)
    x = (_rand(g, b, l, h, p) * 0.5).to(dtype)
    dt = F.softplus(_rand(g, b, l, h) - 1.0)
    a = -torch.exp(_rand(g, h) * 0.5)
    bm = (_rand(g, b, l, n) * 0.3).to(dtype)
    cm = (_rand(g, b, l, n) * 0.3).to(dtype)
    before = ssd_cuda.launches
    y, s = ssd(x, dt, a, bm, cm, chunk=chunk, impl="cuda")
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape and s.dtype == torch.float32
    ry, rs = ssd(x, dt, a, bm, cm, chunk=chunk, impl="torch")
    tol = 2e-5 * math.sqrt(l) if dtype == torch.float32 else 3e-2
    assert rel_err(y, ry) <= tol
    assert rel_err(s, rs) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 3, 256, 64, 64, 128),
                                  (1, 2, 256, 64, 128, 128),
                                  (2, 2, 1000, 64, 64, 128),
                                  (1, 3, 192, 64, 64, 64),
                                  (1, 2, 16, 64, 64, 16),
                                  (2, 3, 48, 16, 16, 16),
                                  (2, 80, 1024, 64, 64, 128)],
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_is_bitwise_the_witness(cuda, case, dtype):
    """K5 against its frozen witness (its first version, csrc/
    ssd_witness.cu) on the operands ``ssd`` hands it: y and the final
    state equal bit for bit.  (2, 80, 1024, 64, 64, 128) is the training
    step's call."""
    b, h, l, p, n, chunk = case
    g = torch.Generator(device=cuda).manual_seed(9)
    x = (_rand(g, b, l, h, p) * 0.5).to(dtype)
    dt = F.softplus(_rand(g, b, l, h) - 1.0)
    a = -torch.exp(_rand(g, h) * 0.5)
    bm = (_rand(g, b, l, n) * 0.3).to(dtype)
    cm = (_rand(g, b, l, n) * 0.3).to(dtype)
    xdt, dta, bm, cm, q = _chip_smoke().ssd_operands(x, dt, a, bm, cm, chunk)
    before = ssd_cuda.launches
    y, s = ssd_cuda(xdt, dta, bm, cm, chunk=q)
    wy, ws = ssd_witness(xdt, dta, bm, cm, chunk=q)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert torch.equal(y, wy) and torch.equal(s, ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", SSD_SHAPES, ids=lambda v: str(v))
def test_ssd_kernel_at_a_ranks_share_of_p(cuda, p, n, dtype):
    """K5 at every width it is built for (P 4-64, N 16/64/128: a rank's
    share of P when a mesh splits it over 'model'): within 2e-5·sqrt(L)
    of its plain version, and every P-column slab of a P = 64 call (and
    of a P = 16 call, the reduced configs', where P < 16) equal bit for
    bit to the kernel's call on that slab alone."""
    b, h, l, chunk = 2, 3, 200, 64
    g = torch.Generator(device=cuda).manual_seed(10 * p + n)
    x = (_rand(g, b, l, h, p) * 0.5).to(dtype)
    dt = F.softplus(_rand(g, b, l, h) - 1.0)
    a = -torch.exp(_rand(g, h) * 0.5)
    bm = (_rand(g, b, l, n) * 0.3).to(dtype)
    cm = (_rand(g, b, l, n) * 0.3).to(dtype)
    before = ssd_cuda.launches
    y, s = ssd(x, dt, a, bm, cm, chunk=chunk, impl="cuda")
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    ry, rs = ssd(x, dt, a, bm, cm, chunk=chunk, impl="torch")
    tol = 2e-5 * math.sqrt(l) if dtype == torch.float32 else 3e-2
    assert rel_err(y, ry) <= tol and rel_err(s, rs) <= tol
    for full in sorted({64, 16} - {p} if p < 16 else {64} - {p}):
        wide = (_rand(g, b, l, h, full) * 0.5).to(dtype)
        xdt, dta, bm_, cm_, q = _chip_smoke().ssd_operands(
            wide, dt, a, bm, cm, chunk)
        wy, ws = ssd_cuda(xdt, dta, bm_, cm_, chunk=q)
        for p0 in range(0, full, p):
            cols = xdt[..., p0:p0 + p].contiguous()
            sy, ss = ssd_cuda(cols, dta, bm_, cm_, chunk=q)
            torch.cuda.synchronize()
            assert torch.equal(sy, wy[..., p0:p0 + p]), (full, p0)
            assert torch.equal(ss, ws[:, :, p0:p0 + p]), (full, p0)


# ------------------------------------------------------ the LM zoo

def _small_hybrid():
    """A narrow zamba2 the kernels take: head dims 64 (attention and SSD),
    state 64, four layers in two groups."""
    return dataclasses.replace(
        reduced(ARCHS["zamba2-2.7b"], n_layers=4, d_model=128, n_heads=2),
        ssm_head_dim=64, ssm_state=64, ssm_chunk=32)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_hybrid_prefill_on_the_card_matches_the_cpu(cuda):
    cfg = _small_hybrid()
    params = init_model(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(9))
    want = prefill_fn(cfg, params, tokens=tokens)
    dev_params = _to(params, cuda)
    counts = (flash_attention_cuda.launches, ssd_cuda.launches,
              tiled_matmul.launches)
    got = prefill_fn(cfg, dev_params, tokens=tokens.to(cuda))
    torch.cuda.synchronize()
    groups = cfg.n_layers // cfg.attn_every
    assert (flash_attention_cuda.launches - counts[0],
            ssd_cuda.launches - counts[1],
            tiled_matmul.launches - counts[2]) == (groups, cfg.n_layers,
                                                   6 * groups + 1)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_hybrid_decode_on_the_card_matches_the_forward(cuda):
    cfg = _small_hybrid()
    params = init_model(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(10))
    with torch.inference_mode():
        full = lm_forward(cfg, params, tokens=tokens)
    cache = init_cache(cfg, 1, 8, dtype=torch.float32, device=cuda)
    before = (flash_attention_cuda.launches, ssd_cuda.launches)
    outs = []
    for i in range(8):
        logits, cache = decode_fn(cfg, params, cache, tokens[:, i:i + 1], i)
        outs.append(logits[:, 0])
    assert (flash_attention_cuda.launches, ssd_cuda.launches) == before
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch,n_layers", [("zamba2-2.7b", 4),
                                           ("mamba2-130m", 2)])
def test_reduced_config_prefills_on_the_card(cuda, arch, n_layers):
    """``reduced()`` configs (head dim 16, SSM P 16, N 16, chunk 16) run
    K4 and K5 on the card, within 1e-4 of the same prefill on the CPU."""
    cfg = reduced(ARCHS[arch], n_layers=n_layers)
    params = init_model(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(19))
    want = prefill_fn(cfg, params, tokens=tokens)
    counts = (flash_attention_cuda.launches, ssd_cuda.launches,
              tiled_matmul.launches)
    got = prefill_fn(cfg, _to(params, cuda), tokens=tokens.to(cuda))
    torch.cuda.synchronize()
    groups = n_layers // cfg.attn_every if cfg.attn_every else 0
    assert flash_attention_cuda.launches - counts[0] == groups
    assert ssd_cuda.launches - counts[1] == n_layers
    assert tiled_matmul.launches - counts[2] > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------- the pipeline and the wave graphs


def _chip_smoke():
    """``chip_smoke.py`` as a module: its stage, wave-graph and
    conv front-end builders are what its card phases run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _alex_on(cuda, frames, seed):
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    params = init_cnn(cfg, torch.Generator().manual_seed(seed), device=cuda)
    x = torch.randn(frames, 32, 32, 3,
                    generator=torch.Generator().manual_seed(seed + 1))
    return cfg, params, x.to(cuda)


def test_two_stage_pipeline_on_k1_and_k3_is_bitwise_the_forward(cuda):
    """CIFAR_Alex+ x64 as 2 micro-batches through two stages pinned to
    ``cuda-tiled`` (conv0 to pool3) and ``neon-vpu`` (conv4 to fc7): the
    logits are the dispatcher forward's bits, and each kernel launches
    once per GEMM of its stage."""
    cs = _chip_smoke()
    cfg, params, x = _alex_on(cuda, 64, 20)
    want = cnn_forward(cfg, params, x)
    split = [("front", 0, 4, "cuda-tiled"), ("back", 4, 8, "neon-vpu")]
    launches = (tiled_matmul.launches, vpu_matmul.launches)
    outs, stats = ThreadedPipeline(cs.pipeline_stages(cfg, params, split)
                                   ).run(list(x.split(32)))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs), want)
    per_mb = cs.pipe_launches(cfg, split)
    assert (tiled_matmul.launches - launches[0],
            vpu_matmul.launches - launches[1]) == (
        2 * per_mb["tiled_mm"], 2 * per_mb["vpu_mm"]) == (4, 6)
    assert stats["stage_engines"] == {"front": "cuda-tiled",
                                      "back": "neon-vpu"}


def test_wave_graphs_on_the_card_are_bitwise_the_conv_front_end(cuda):
    """Two 8-frame CIFAR_Alex+ waves in flight at once as graphs over K1 +
    K3 (32-row panels, gathers on the host executor's default stream):
    each wave's last node is the dispatcher's conv front-end bits, and so
    is the chain mode's."""
    cs = _chip_smoke()
    cfg, params, x = _alex_on(cuda, 16, 22)
    want = cs.conv_front(cfg, params, x)
    waves = list(x.split(8))
    rows = want.shape[0] // len(waves)
    launches = (tiled_matmul.launches, vpu_matmul.launches)
    with SynergyRuntime(POOL, device=cuda) as rt:
        vals = [f.result(60)[-1]
                for f in cs.graph_waves(rt, cfg, params, waves)]
        torch.cuda.synchronize()
        ran = (tiled_matmul.launches - launches[0]
               + vpu_matmul.launches - launches[1])
        chain = cs.chain_waves(rt, cfg, params, waves)
    for w in range(len(waves)):
        assert torch.equal(vals[w], want[w * rows:(w + 1) * rows]), w
        assert torch.equal(chain[w], want[w * rows:(w + 1) * rows]), w
    assert ran == len(waves) * sum(js.grid[0] for _, js in
                                   conv_jobsets(cfg, 8))


def test_graph_cancel_on_the_card_drains_queued_panels(cuda):
    """Cancelling a 32-frame wave graph once its conv0 panels are queued
    drains them (fewer than all 1,024 launch), cancels every later node,
    ends the graph in ``GraphCancelled``, and the runtime then runs a
    fresh wave to the dispatcher's bits."""
    cs = _chip_smoke()
    cfg, params, x = _alex_on(cuda, 32, 24)
    with SynergyRuntime(POOL, device=cuda) as rt:
        launches = tiled_matmul.launches + vpu_matmul.launches
        gf, = cs.graph_waves(rt, cfg, params, [x], name="cancel")
        deadline = time.monotonic() + 60
        while gf.node_future(1) is None:
            assert time.monotonic() < deadline
            time.sleep(1e-4)
        assert gf.cancel("card cancel") == 4
        with pytest.raises(GraphCancelled):
            gf.result(60)
        torch.cuda.synchronize()
        ran = tiled_matmul.launches + vpu_matmul.launches - launches
        assert ran < 1024
        assert gf.node_states() == ["done", "failed"] + ["cancelled"] * 4
        fresh, = cs.graph_waves(rt, cfg, params, [x], name="after")
        got = fresh.result(60)[-1]
    assert torch.equal(got, cs.conv_front(cfg, params, x))


# ------------------------------------------------- faults on the card

class _FiringPlan(FaultPlan):
    """A FaultPlan whose ``fired`` event sets at its first injection."""

    def __init__(self, specs, seed=None):
        super().__init__(specs, seed=seed)
        self.fired = threading.Event()

    def record(self, engine, kind, call):
        super().record(engine, kind, call)
        self.fired.set()


class _AfterFault(Engine):
    """``inner``'s panels start once ``plan`` has injected a fault, so the
    faulty engine takes a panel whatever the host's thread timing."""

    def __init__(self, inner, plan):
        super().__init__(inner.name, set(inner.capabilities),
                         cost=inner._cost)
        self.inner, self.plan = inner, plan
        self.telemetry = inner.telemetry

    def cost_on(self, device):
        return self.inner.cost_on(device)

    def execute(self, a, b, **kw):
        if not self.plan.fired.wait(60):
            raise TimeoutError("the planned fault never fired")
        return self.inner.execute(a, b, **kw)


#: kind -> (the RetryPolicy that recovers it, launches it throws away)
FAULT_CASES = {
    "raise": (RetryPolicy(max_attempts=3), 0),
    "corrupt": (RetryPolicy(max_attempts=3, check_outputs=True), 1),
    "drop": (RetryPolicy(stall_timeout_s=1.0, heartbeat_timeout_s=1.0,
                         monitor_interval_s=0.05), 1),
    "die": (RetryPolicy(heartbeat_timeout_s=1.0, monitor_interval_s=0.05),
            0)}


@pytest.mark.parametrize("kind", sorted(FAULT_CASES))
def test_fault_on_the_card_is_bitwise_the_fault_free_split(cuda, kind):
    """neon-vpu's first panel faults (``cuda-tiled`` starts once it has):
    the recovered split of CUDA tensors is bitwise the fault-free one,
    every panel merged once, and K1 + K3 launched the panels plus the
    attempts thrown away (a corrupt or dropped panel ran its kernel)."""
    retry, wasted = FAULT_CASES[kind]
    g = torch.Generator(device=cuda).manual_seed(31)
    m, n, k = 16 * 32, 64, 300
    a, b, bias = _rand(g, m, k), _rand(g, k, n), _rand(g, n)
    js = JobSet.for_gemm(0, m, n, k, 32)
    kw = dict(jobset=js, bias=bias, activation=torch.relu, tile=(32, 32, 32))
    with SynergyRuntime(POOL, device=cuda) as rt:
        want = rt.submit_gemm(a, b, **kw).result(60)
    plan = _FiringPlan((FaultSpec("neon-vpu", kind, at_call=0),), seed=0)
    pool = wrap_pool([_AfterFault(get_engine("cuda-tiled"), plan),
                      get_engine("neon-vpu")], plan)
    launches = (tiled_matmul.launches, vpu_matmul.launches)
    with SynergyRuntime(pool, device=cuda, retry=retry) as rt:
        fut = rt.submit_gemm(a, b, affinity="neon-vpu", **kw)
        y = fut.result(60)
        torch.cuda.synchronize()
        stats = rt.stats()
    assert plan.injected == [("neon-vpu", kind, 0)]
    assert torch.equal(y, want)
    assert fut.execution_counts == [1] * js.grid[0]
    ran = (tiled_matmul.launches - launches[0]
           + vpu_matmul.launches - launches[1])
    assert ran == js.grid[0] + wasted
    if kind == "die":
        assert stats["worker_deaths"] == 1 and stats["orphan_reseeds"] >= 1
    else:
        assert stats["retries"] == 1


def test_slowdown_on_the_card_scales_the_panels_device_time(cuda):
    """A slowdown of factor f adds at least (f-1)x the panel's CUDA-event
    time: the fault waits for the device work before it reads the
    panel's time (a launch alone returns in microseconds)."""
    factor = 10.0
    g = torch.Generator(device=cuda).manual_seed(32)
    a, b = _rand(g, 8192, 1600), _rand(g, 1600, 64)
    eng = get_engine("neon-vpu")
    eng.execute(a, b)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    eng.execute(a, b)
    end.record()
    torch.cuda.synchronize()
    panel_s = start.elapsed_time(end) / 1e3
    slow = FaultyEngine(eng, FaultPlan((FaultSpec(
        "neon-vpu", "slowdown", at_call=0, count=1, factor=factor),)))
    t0 = time.perf_counter()
    y = slow.execute(a, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert torch.equal(y, eng.execute(a, b))
    assert wall - panel_s >= (factor - 1.0) * panel_s, (wall, panel_s)


def test_integrity_screen_runs_on_the_worker_stream(cuda):
    """With ``check_outputs`` every panel's NaN/Inf screen is queued on its
    worker's stream: a second of work that the submitter queues on its own
    stream after the submit does not hold the result back."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    cycles_per_s = 1e8 / (start.elapsed_time(end) / 1e3)
    g = torch.Generator(device=cuda).manual_seed(33)
    m, n, k = 16 * 32, 64, 300
    a, b = _rand(g, m, k), _rand(g, k, n)
    js = JobSet.for_gemm(0, m, n, k, 32)
    with SynergyRuntime(POOL, device=cuda,
                        retry=RetryPolicy(check_outputs=True)) as rt:
        want = rt.submit_gemm(a, b, jobset=js, tile=(32, 32, 32)).result(60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fut = rt.submit_gemm(a, b, jobset=js, tile=(32, 32, 32))
        torch.cuda._sleep(int(cycles_per_s))      # ~1 s on this stream
        y = fut.result(60)
        waited = time.perf_counter() - t0
        torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert waited < 0.5, waited


# ------------------------------------------------------------- the server


def test_server_on_the_card_matches_the_cpu_and_its_decode_modes(cuda):
    """``chip_smoke.py``'s dense serving check: a reduced granite server
    (the real-FFN decode GEMM) over ``SynergyRuntime(POOL)`` on the card
    gives each request the CPU server's tokens in both decode modes,
    batched decode is BITWISE per-slot, the decode-GEMM outputs are within
    1e-5·sqrt(k) of the CPU's and of the plain version on their own
    inputs, and K1 launched on the card and not on the CPU."""
    dense = _chip_smoke().phase_serving_dense()
    assert dense["launches"]["tiled_mm"] > 0
    assert dense["per_slot_launches"]["tiled_mm"] > 0
    assert dense["decode_steps"] > 0
    assert not any(dense["cpu_launches"].values())


# ------------------------------------------------------------ durability

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trips_card_tensors_bitwise(cuda, tmp_path, dtype):
    """Card tensors through the Checkpointer, bitwise: an async save is a
    host copy taken after every stream's queued work, so a kernel that
    writes the tensor in place right after ``save`` returns (as the next
    decode step writes the caches) does not reach the file; ``restore``
    gives them back on the card."""
    g = torch.Generator(cuda).manual_seed(23)
    state = {"cache": {"k": _rand(g, 4, 3, 64, 80, dtype=dtype),
                       "ssm": _rand(g, 2, 4, 8, 64, 64, dtype=dtype)},
             "pos": torch.arange(4, dtype=torch.int32, device=cuda)}
    saved = {"k": state["cache"]["k"].clone() * 3.0,
             "ssm": state["cache"]["ssm"].clone()}
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):             # queued on another stream
        state["cache"]["k"].mul_(3.0)
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(1, state)
    state["cache"]["k"].add_(1.0)
    state["cache"]["ssm"].zero_()
    ck.wait()
    got = ck.restore(state, device=cuda)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    for k in ("k", "ssm"):
        t = got["cache"][k]
        assert t.device.type == "cuda" and t.dtype == dtype
        assert torch.equal(bits(t), bits(saved[k]))
    assert torch.equal(got["pos"], state["pos"])


def test_durable_server_on_the_card_restores_the_cpu_tokens(cuda, tmp_path):
    """``chip_smoke.py``'s reduced granite server with ``Durability`` on the
    card: a crash at engine step 6 (a snapshot taken, decode live,
    requests queued) and a restore on a fresh runtime give every request
    the CPU server's uninterrupted tokens, with each token served once."""
    cs = _chip_smoke()
    cfg, params, cnn = cs.dense_model()
    cpu = cs.serve_run(cfg, params, POOL, device="cpu", cnn_params=cnn)
    kw = dict(slots=cs.SERVE_SLOTS, max_len=cs.SERVE_MAX_LEN,
              prefill_len=cs.SERVE_PROMPT, cnn_params=_to(cnn, cuda),
              device=cuda)
    params = _to(params, cuda)
    d = Durability(str(tmp_path), snapshot_every=4, keep=2)
    reqs = cs.serve_requests(cfg)
    with SynergyRuntime(POOL, name="durable-card", device=cuda) as rt:
        srv = SynergyServer(cfg, params, runtime=rt, durable=d,
                            crash_plan=CrashPlan(at_step=6), **kw)
        with pytest.raises(SimulatedCrash):
            for r in reqs:
                srv.submit(r)
            srv.run()
        assert srv.stats.snapshots and srv.pending
        srv._ck.wait()
    with SynergyRuntime(POOL, name="durable-card-2", device=cuda) as rt:
        srv2 = SynergyServer.restore(cfg, params, durable=d, runtime=rt,
                                     **kw)
        assert srv2.stats.replayed_tokens > 0
        assert srv2.cache["k"].device.type == "cuda"
        srv2.run()
        srv2._ck.wait()
    got = {rid: list(r.out) for rid, r in srv2.restored_requests.items()}
    assert [got.get(r.rid, list(r.out)) for r in reqs] == cpu["tokens"]
    assert (srv2.stats.tokens_out + srv2.stats.replayed_tokens
            == cpu["stats"].tokens_out)
    assert srv2.stats.restores == 1


# ---------------------------------------------------------- the training path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,causal", [(4, True), (2, True), (1, False)])
def test_flash_attention_backward_matches_plain_autograd(cuda, hkv, causal,
                                                         dtype):
    """K4 under autograd (``FlashAttentionFunction``: the kernel forward,
    ``attention_ref``'s VJP) against autograd of ``attention_ref``, at the
    reduced configs' head dim 16."""
    g = torch.Generator(cuda).manual_seed(30)
    q, k, v = (torch.randn(2, 4 if i == 0 else hkv, 64, 16, device=cuda,
                           generator=g).to(dtype).requires_grad_()
               for i in range(3))
    go = torch.randn(2, 4, 64, 16, device=cuda, generator=g).to(dtype)
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(q, k, v, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    assert type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(o, (q, k, v), go)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=causal),
                               (q, k, v), go)
    tol = 2e-5 * math.sqrt(64) if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert rel_err(a, b) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_matches_plain_autograd(cuda, dtype):
    """K5 under autograd (``SSDFunction``: the kernel forward,
    ``ssd_chunked``'s VJP) against autograd of ``impl="torch"``, through
    y and the final state, at the reduced configs' P 16, N 16, chunk 16."""
    g = torch.Generator(cuda).manual_seed(31)
    b, l, h, p, n = 2, 64, 8, 16, 16
    x = (torch.randn(b, l, h, p, device=cuda, generator=g) * 0.5).to(dtype)
    dt = F.softplus(torch.randn(b, l, h, device=cuda, generator=g) - 1.0)
    a = -torch.exp(torch.randn(h, device=cuda, generator=g) * 0.5)
    bm = (torch.randn(b, l, n, device=cuda, generator=g) * 0.3).to(dtype)
    cm = (torch.randn(b, l, n, device=cuda, generator=g) * 0.3).to(dtype)
    inp = tuple(t.requires_grad_() for t in (x, dt, a, bm, cm))
    gy = torch.randn(b, l, h, p, device=cuda, generator=g).to(dtype)
    gs = torch.randn(b, h, p, n, device=cuda, generator=g)
    before = ssd_cuda.launches
    y, s = ssd(*inp, chunk=16, impl="cuda")
    assert ssd_cuda.launches == before + 1
    got = torch.autograd.grad((y, s), inp, (gy, gs))
    ry, rs = ssd(*inp, chunk=16, impl="torch")
    want = torch.autograd.grad((ry, rs), inp, (gy, gs))
    tol = 2e-5 * math.sqrt(l) if dtype == torch.float32 else 3e-2
    for a_, b_ in zip(got, want):
        assert rel_err(a_, b_) <= tol


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """Two train steps of the reduced zamba2 (4 layers, fp32, remat) from
    one CPU state, on the card (K4 once per group, K5 twice per layer, K1
    never) and on the CPU: losses and every state leaf within 1e-4 of the
    CPU leaf's largest entry."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch import build_train_step, make_train_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced(ARCHS["zamba2-2.7b"], n_layers=4)
    cell = ShapeCell("t", 64, 2, "train")
    state0 = make_train_state(cfg, 5, device="cpu")
    step_fn, _, _ = build_train_step(cfg, cell)
    runs = {}
    for dev in ("cpu", cuda):
        state = tree_map(lambda t: t.to(dev, copy=True), state0)
        before = (flash_attention_cuda.launches, ssd_cuda.launches,
                  tiled_matmul.launches)
        losses = []
        for i in range(2):
            state, m = step_fn(state, make_batch(cfg, cell, 1, i,
                                                 device=dev))
            losses.append(float(m["loss"]))
        runs[str(dev)] = (state, losses, (
            flash_attention_cuda.launches - before[0],
            ssd_cuda.launches - before[1],
            tiled_matmul.launches - before[2]))
    (cpu, cpu_losses, _), (card, card_losses, counts) = runs["cpu"], \
        runs[str(cuda)]
    groups = cfg.n_layers // cfg.attn_every
    assert counts == (2 * groups, 2 * 2 * cfg.n_layers, 0)
    for a, b in zip(card_losses, cpu_losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        assert a.device.type == "cuda"
        if b.dim():
            assert rel_err(a.cpu(), b) <= 1e-4
        else:
            assert int(a) == int(b)


def test_one_rank_mesh_on_the_card_is_bitwise_the_unsharded_steps(cuda):
    """The reduced zamba2 (4 layers) over a mesh of one NCCL rank: the
    prefill step's logits, 4 decode steps' logits and cache (written in
    place) and one AdamW train step's loss, metrics and state
    ``torch.equal`` to the unsharded functions', through K4 and K5."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch import (build_train_step, make_test_mesh,
                                    make_train_state, place_tree)
    from repro_torch.launch.serve import build_decode_step, build_prefill_step
    from repro_torch.tree import tree_leaves
    cfg = reduced(ARCHS["zamba2-2.7b"], n_layers=4)
    b, s, max_len = 2, 64, 16
    params = init_model(cfg, 3, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    cell = ShapeCell("t", s, b, "train")
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_test_mesh(data=1, model=1, device_type="cuda")
        prefill, (_, pspecs), _ = build_prefill_step(
            cfg, ShapeCell("p", s, b, "prefill"), mesh)
        before = (flash_attention_cuda.launches, ssd_cuda.launches)
        got = prefill(place_tree(params, pspecs, mesh), {"tokens": tokens})
        assert (flash_attention_cuda.launches - before[0],
                ssd_cuda.launches - before[1]) == (
            cfg.n_layers // cfg.attn_every, cfg.n_layers)
        want = prefill_fn(cfg, params, tokens=tokens)
        assert torch.equal(got, want)

        decode, (_, dspecs), (_, bspecs) = build_decode_step(
            cfg, ShapeCell("d", max_len, b, "decode"), mesh)
        placed = place_tree(params, dspecs, mesh)
        ref = init_cache(cfg, b, max_len, device=cuda)
        fresh = init_cache(cfg, b, max_len, device=cuda)
        cache = place_tree(fresh, bspecs["cache"], mesh)
        tok = want[:, -1].argmax(dim=-1, keepdim=True)
        for i in range(4):
            w, ref = decode_fn(cfg, params, ref, tok, i)
            g, cache = decode(placed, cache, tok, i)
            assert torch.equal(g, w)
            tok = w[:, -1].argmax(dim=-1, keepdim=True)
        for a, r, f in zip(tree_leaves(cache), tree_leaves(ref),
                           tree_leaves(fresh)):
            assert torch.equal(a.to_local(), r)
            assert a.to_local().data_ptr() == f.data_ptr()

        batch = make_batch(cfg, cell, seed=0, step=0, device=cuda)
        runs = []
        for m in (None, mesh):
            step_fn, (_, sspecs), _ = build_train_step(cfg, cell, m)
            state = make_train_state(cfg, 5, device=cuda)
            if m is not None:
                state = place_tree(state, sspecs, m)
            runs.append(step_fn(state, batch))
        (ref_state, ref_m), (state, metrics) = runs
        for k, v in ref_m.items():
            assert torch.equal(metrics[k], v), k
        for a, r in zip(tree_leaves(state), tree_leaves(ref_state)):
            assert torch.equal(a.to_local(), r)
    finally:
        dist.destroy_process_group()


def test_meta_path_rules_are_the_kernels_choices(cuda):
    """The Python path rules that traced ``meta`` GEMMs report give the
    compiled kernels' own choices (``tiled_mm_path``, ``qmm_path``)."""
    from repro_torch.kernels.qmm.qmm import _qmm_path
    from repro_torch.kernels.qmm.qmm import path_rule as qmm_rule
    from repro_torch.kernels.tiled_mm.tiled_mm import path_rule, tiled_mm_path
    sizes = (1, 7, 8, 9, 15, 16, 17, 24, 32, 33, 64, 75, 2560)
    for n in sizes:
        for k in sizes:
            for code in (0, 1):
                assert path_rule(n, k, code) == tiled_mm_path(n, k, code)
            for a_mod in (0, 1, 8):
                for w_mod in (0, 4):
                    assert qmm_rule(a_mod, w_mod, n, k) == _qmm_path(
                        a_mod, w_mod, n, k)


def test_traced_kernel_calls_are_the_card_launches(cuda):
    """The reduced zamba2 (4 layers, bf16 compute) prefill and train step
    traced on ``meta`` (``analyze_step``) call each kernel, on each K1
    path, as often as the card launches it on the same shapes."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch import build_train_step, make_train_state
    from repro_torch.launch.hlo_analysis import analyze_step
    cfg = dataclasses.replace(reduced(ARCHS["zamba2-2.7b"], n_layers=4),
                              compute_dtype="bfloat16")
    wrappers = {"tiled_mm": tiled_matmul, "vpu_mm": vpu_matmul,
                "qmm": qmm_matmul, "flash_attention": flash_attention_cuda,
                "ssd": ssd_cuda}

    def launches(run):
        before = {k: w.launches for k, w in wrappers.items()}
        paths = dict(tiled_matmul.launches_by_path)
        run()
        torch.cuda.synchronize()
        got = {k: w.launches - before[k] for k, w in wrappers.items()}
        return ({k: v for k, v in got.items() if v},
                {p: n - paths[p] for p, n in
                 tiled_matmul.launches_by_path.items() if n - paths[p]})

    params = init_model(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda)
    card, card_paths = launches(lambda: prefill_fn(cfg, params,
                                                   tokens=tokens))
    _, acct = analyze_step(prefill_fn, cfg, init_model(cfg, 0,
                                                       device="meta"),
                           tokens=tokens.to("meta"))
    assert acct.kernels == card and card["tiled_mm"] > 0
    assert acct.kernel_paths == {"tiled_mm": card_paths}
    cell = ShapeCell("t", 64, 2, "train")
    step_fn, (aval, _), _ = build_train_step(cfg, cell)
    state = make_train_state(cfg, 0, device=cuda)
    batch = make_batch(cfg, cell, 1, 0, device=cuda)
    card, _ = launches(lambda: step_fn(state, batch))
    _, acct = analyze_step(step_fn, aval,
                           {k: v.to("meta") for k, v in batch.items()})
    assert acct.kernels == card and card["ssd"] > 0


@pytest.mark.parametrize("slice_bytes", [None, 32 * 36 * 4])
def test_sliced_adafactor_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                      slice_bytes):
    """Adafactor taken slice by slice on the card: stacked leaves
    (factored (2, 3, 32, 36) and (4, 48, 40), unfactored (3, 5, 8)) and
    whole ones, three steps against the same steps on the CPU within 1e-5
    of each leaf's largest entry, and the in-place update bit for bit the
    functional one on the card; with ``SLICE_BYTES`` lowered, slices
    finer than the first dimension."""
    from repro_torch.optim import (AdafactorConfig, adafactor as af,
                                   adafactor_init, adafactor_update)
    from repro_torch.tree import tree_leaves, tree_map
    if slice_bytes is not None:
        monkeypatch.setattr(af, "SLICE_BYTES", slice_bytes)
    shapes = {"s4": (2, 3, 32, 36), "s": (4, 48, 40), "u": (3, 5, 8),
              "w": (48, 64), "b": (7,)}
    g = torch.Generator().manual_seed(17)
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    cfg = AdafactorConfig(weight_decay=0.01)
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        state = adafactor_init(p)
        gen = torch.Generator().manual_seed(18)
        for step in range(3):
            grads = {k: (0.3 * (step + 1) * torch.randn(
                s, generator=gen)).to(dev) for k, s in shapes.items()}
            want_p, want_s, _ = adafactor_update(cfg, grads, state, p)
            p, state, _ = adafactor_update(cfg, grads, state, p,
                                           inplace=True)
            for a, b in zip(tree_leaves({"p": want_p, "s": want_s}),
                            tree_leaves({"p": p, "s": state})):
                assert torch.equal(a, b)
        runs[str(dev)] = {"p": p, "s": state}
    for a, b in zip(tree_leaves(runs[str(cuda)]), tree_leaves(runs["cpu"])):
        assert a.device.type == "cuda"
        if b.dim():
            assert rel_err(a.cpu(), b) <= 1e-5
        else:
            assert int(a) == int(b)


def test_moe_adafactor_steps_on_the_card_match_the_cpu(cuda):
    """The reduced kimi-k2 (MoE, Adafactor; 3 layers of 8 experts, fp32,
    remat) two train steps from one CPU state on the card and on the
    CPU: losses and factored parameters within 1e-4 of the CPU's
    (relative, of the leaf's largest entry), the statistics within 1e-3,
    an unfactored parameter within Adafactor's own bound on an entry's
    two moves (2·lr·t^0.4 a step: its update g/√v is ±1 where g is at
    rounding level); K4's launches a step equal to the calls of the step
    traced on ``meta``, K1 never."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch import build_train_step, make_train_state
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced(ARCHS["kimi-k2-1t-a32b"], n_layers=3, n_experts=8)
    assert cfg.optimizer == "adafactor"
    cell = ShapeCell("t", 64, 2, "train")
    state0 = make_train_state(cfg, 6, device="cpu")
    step_fn, (aval, _), (ins, _) = build_train_step(cfg, cell)
    _, acct = analyze_step(step_fn, aval, ins)
    runs = {}
    for dev in ("cpu", cuda):
        state = tree_map(lambda t: t.to(dev, copy=True), state0)
        losses, counts = [], []
        for i in range(2):
            before = (flash_attention_cuda.launches, tiled_matmul.launches)
            state, m = step_fn(state, make_batch(cfg, cell, 1, i,
                                                 device=dev))
            losses.append(float(m["loss"]))
            counts.append((flash_attention_cuda.launches - before[0],
                           tiled_matmul.launches - before[1]))
        runs[str(dev)] = (state, losses, counts)
    (cpu, cpu_losses, _), (card, card_losses, counts) = runs["cpu"], \
        runs[str(cuda)]
    assert acct.kernels["flash_attention"] > 0
    assert counts == [(acct.kernels["flash_attention"], 0)] * 2
    for a, b in zip(card_losses, cpu_losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    lr = 1e-2                           # AdafactorConfig's
    bound = sum(2 * lr * t ** 0.4 for t in (1, 2))
    for key in ("params", "opt"):
        for a, b in zip(tree_leaves(card[key]), tree_leaves(cpu[key])):
            assert a.device.type == "cuda"
            if not b.dim():
                assert int(a) == int(b)
            elif key == "opt":
                assert rel_err(a.cpu(), b) <= 1e-3
            elif b.dim() >= 2 and min(b.shape[-2:]) >= 32:
                assert rel_err(a.cpu(), b) <= 1e-4
            else:
                assert float((a.cpu() - b).abs().max()) <= bound
    assert int(card["step"]) == int(cpu["step"]) == 2
