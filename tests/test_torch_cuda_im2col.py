"""The im2col kernel on the card (``repro_torch/kernels/im2col``): its
patches, and ``im2col_wave``'s, bitwise the plain version run on the same
input moved to the CPU, over the CPU tests' geometries, CIFAR_Alex+'s
three convs at batches 1, 256 and 1,024, strides 1-3 with paddings 0-2
and C 1, 3, 4 and 64, in every dtype the wrapper takes; one launch a
call; the kernel's access width equal to ``access_rule``; a CIFAR_Alex+
forward that opens no ``im2col.upload`` span, totals no uploads and 3
``im2col_launches``, and whose logits are bitwise those of the forward
lowered by the plain version on the CPU.

Every test here needs a card (marker ``requires_cuda``) and skips without
one.  On a machine with a card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_im2col.py
"""

import pytest
import torch

from repro_torch.configs import PAPER_CNNS
from repro_torch.core.im2col import im2col, im2col_wave
from repro_torch.kernels.im2col import (access_rule, im2col_cuda,
                                        im2col_ref, load_im2col)
from repro_torch.kernels.im2col.ops import DTYPES
from repro_torch.models import cnn
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.obs import trace

pytestmark = pytest.mark.requires_cuda

CFG = PAPER_CNNS["CIFAR_Alex+"]
#: tests/test_torch_im2col.py's (h, w, c, kernel, stride, padding)
_GEOMETRIES = [(12, 12, 3, 5, 1, 2), (9, 7, 2, 3, 2, 1), (8, 8, 4, 1, 1, 0),
               (32, 32, 3, 5, 1, 2), (6, 10, 1, 3, 3, 0)]
#: CIFAR_Alex+'s convs, the same fields
_ALEX = [(h, w, c, spec[2], spec[3], spec[4])
         for spec, h, w, c in CFG.trace_shapes()[0] if spec[0] == "conv"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _input(shape, dtype, seed: int = 0) -> torch.Tensor:
    """Made on the CPU: normal values for a float dtype, the whole range
    for an int one."""
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, generator=g,
                         dtype=dtype)


def _check(cuda, x: torch.Tensor, k: int, stride: int, pad: int) -> None:
    """im2col and im2col_wave of ``x`` on the card, one launch each,
    bitwise the plain version on ``x`` on the CPU."""
    want = im2col_ref(x, k, k, stride, pad)
    xc = x.to(cuda)
    before = im2col_cuda.launches
    got = im2col(xc, k, k, stride, pad)
    assert im2col_cuda.launches == before + 1
    wave = im2col_wave(xc, k, k, stride, pad)
    assert im2col_cuda.launches == before + 2
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(wave.cpu(), want.reshape(-1, want.shape[-1]))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("geom", _GEOMETRIES)
def test_patches_are_bitwise_the_plain_version(cuda, geom, dtype):
    h, w, c, k, s, p = geom
    _check(cuda, _input((2, h, w, c), dtype), k, s, p)


@pytest.mark.parametrize("batch", [1, 256, 1024])
@pytest.mark.parametrize("conv", range(len(_ALEX)))
def test_alex_convs_are_bitwise_the_plain_version(cuda, conv, batch):
    h, w, c, k, s, p = _ALEX[conv]
    _check(cuda, _input((batch, h, w, c), torch.float32, seed=batch), k, s,
           p)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", [1, 3, 4, 64])
@pytest.mark.parametrize("pad", [0, 1, 2])
@pytest.mark.parametrize("stride", [2, 3])
def test_strides_paddings_and_channels(cuda, stride, pad, c, dtype):
    _check(cuda, _input((3, 11, 9, c), dtype, seed=c), 3, stride, pad)


def test_a_misaligned_view_is_copied_first(cuda):
    flat = _input((1 + 2 * 8 * 8 * 4,), torch.float32).to(cuda)
    x = flat[1:].view(2, 8, 8, 4)          # 4 bytes past a boundary
    assert x.data_ptr() % access_rule(4, 36, 4)
    got = im2col(x, 3, 3, 1, 1)
    assert torch.equal(got.cpu(), im2col_ref(x.cpu(), 3, 3, 1, 1))


def test_access_width_is_the_rule(cuda):
    lib = load_im2col()
    for c in (1, 2, 3, 4, 6, 8, 64, 128):
        for kk in (1, 3, 5):
            for size in (1, 2, 4):
                k = kk * kk * c
                assert lib.im2col_vec(c, k, size) == access_rule(c, k, size)


@pytest.fixture
def net(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_cnn(CFG, g, device=cuda)
    x = torch.randn(256, CFG.input_hw, CFG.input_hw, CFG.cin, device=cuda,
                    generator=g)
    return params, x


def test_forward_launches_im2col_thrice_and_uploads_nothing(cuda, net):
    params, x = net
    cnn_forward(CFG, params, x, device=cuda)     # warm: kernels built
    before = im2col_cuda.launches
    with trace.trace_scope(trace.Tracer()) as tracer:
        cnn_forward(CFG, params, x, device=cuda)
        torch.cuda.synchronize()
    spans = tracer.events()
    assert im2col_cuda.launches == before + 3
    assert not [e for e in spans if e.kind == "im2col.upload"]
    (forward,) = [e for e in spans if e.kind == "cnn.forward"]
    assert forward.tags.get("uploads", 0) == 0
    assert forward.tags.get("upload_bytes", 0) == 0
    assert forward.tags["im2col_launches"] == 3
    assert forward.tags["launches"] == 5
    assert [e.tags["im2col_launches"] for e in spans
            if e.kind == "im2col"] == [1, 1, 1]


def test_forward_logits_are_those_of_the_plain_lowering(cuda, net,
                                                        monkeypatch):
    params, x = net
    logits = cnn_forward(CFG, params, x, device=cuda)

    def on_the_cpu(x, kh, kw, stride, pad):
        return im2col_ref(x.cpu(), kh, kw, stride, pad).to(x.device)

    monkeypatch.setattr(cnn, "im2col", on_the_cpu)
    before = im2col_cuda.launches
    plain = cnn_forward(CFG, params, x, device=cuda)
    assert im2col_cuda.launches == before
    assert torch.equal(logits, plain)
