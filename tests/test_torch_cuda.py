"""The CUDA kernels on the card: tiled_mm (K1) and vpu_mm (K3) against
their plain versions, row panels bit-stable, K3 bitwise equal to K1 and
free of tensor-core instructions, the dispatcher routing CUDA tensors onto
K1, and the work-stealing runtime splitting GEMMs over both kernels with
results bitwise equal to the unsplit K1 GEMM.

Every test here needs a card (marker ``requires_cuda``) and skips without
one.  On a machine with a card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import PAPER_CNNS
from repro_torch.core.job import JobSet
from repro_torch.core.synergy_mm import SynergyTrace, synergy_matmul
from repro_torch.kernels.common.build import sass_opcodes
from repro_torch.kernels.tiled_mm import tiled_matmul, tiled_mm_ref
from repro_torch.kernels.vpu_mm import vpu_matmul, vpu_mm_library, vpu_mm_ref
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.soc import SynergyRuntime

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
