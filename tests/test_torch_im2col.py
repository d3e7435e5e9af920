"""The port's im2col lowering against repro's: the gather is bitwise equal,
the conv it builds matches torch's own conv (an oracle only, after the
NHWC/HWIO -> NCHW/OIHW permutation), and the output geometry agrees.  The
card kernel's access-width rule, its wrapper's refusals, and its launch
count among the kernels' (the kernel itself is tested on the card, in
tests/test_torch_cuda_im2col.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.im2col import conv_out_shape as jax_conv_out_shape
from repro.core.im2col import im2col as jax_im2col
from repro.core.im2col import im2col_wave as jax_im2col_wave
from repro_torch.core.im2col import (conv2d_gemm, conv_out_shape, im2col,
                                     im2col_wave)
from repro_torch.kernels.im2col import access_rule, im2col_cuda
from repro_torch.kernels.launches import launch_counts, reset_launches

_GEOMETRIES = [(12, 12, 3, 5, 1, 2), (9, 7, 2, 3, 2, 1), (8, 8, 4, 1, 1, 0),
               (32, 32, 3, 5, 1, 2), (6, 10, 1, 3, 3, 0)]


@pytest.mark.parametrize("geom", _GEOMETRIES)
def test_im2col_is_bitwise_equal(geom):
    h, w, c, k, s, p = geom
    x = np.random.default_rng(0).standard_normal((2, h, w, c)).astype(
        np.float32)
    ours = im2col(torch.from_numpy(x), k, k, s, p).numpy()
    theirs = np.asarray(jax_im2col(jnp.asarray(x), k, k, s, p))
    np.testing.assert_array_equal(ours, theirs)
    wave = im2col_wave(torch.from_numpy(x), k, k, s, p).numpy()
    np.testing.assert_array_equal(
        wave, np.asarray(jax_im2col_wave(jnp.asarray(x), k, k, s, p)))
    assert (conv_out_shape(h, w, k, k, s, p)
            == jax_conv_out_shape(h, w, k, k, s, p))


@pytest.mark.parametrize("geom", _GEOMETRIES)
def test_conv2d_gemm_matches_torch_conv(geom):
    h, w, c, k, s, p = geom
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((k, k, c, 7)).astype(
        np.float32))
    out = conv2d_gemm(x, wt, stride=s, padding=p)
    ref = F.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), stride=s,
                   padding=p).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c, k, elem_size, width", [
    (3, 75, 4, 4),        # CIFAR_Alex+ conv0: rows of 300 B
    (64, 1600, 4, 16),    # conv2 and conv4
    (3, 75, 2, 2), (3, 75, 1, 1), (64, 1600, 2, 16), (64, 1600, 1, 16),
    (2, 18, 4, 8), (4, 36, 4, 16), (1, 9, 4, 4), (6, 54, 2, 4),
    (8, 8, 1, 8), (2, 50, 2, 4), (1, 25, 2, 2)])
def test_access_width_rule(c, k, elem_size, width):
    assert access_rule(c, k, elem_size) == width
    assert (c * elem_size) % width == 0 and (k * elem_size) % width == 0


@pytest.mark.parametrize("x, exc", [
    (torch.zeros(2, 8, 8, 3), ValueError),                  # on the CPU
    (torch.zeros(8, 8, 3), ValueError),                     # rank 3
    (torch.zeros(2, 8, 8, 3, dtype=torch.float64), TypeError),
    (torch.zeros(2, 8, 8, 3, dtype=torch.bool), TypeError),
    (torch.zeros(2, 8, 8, 3, device="meta"), ValueError)])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(x, exc):
    before = im2col_cuda.launches
    with pytest.raises(exc):
        im2col_cuda(x, 3, 3, 1, 1)
    assert im2col_cuda.launches == before


def test_im2col_launches_are_counted_with_the_kernels():
    x = torch.zeros(2, 8, 8, 3)
    im2col(x, 3, 3, 1, 1)                  # a CPU tensor: the plain version
    assert launch_counts()["im2col"] == 0
    im2col_cuda.launches = 4
    assert launch_counts()["im2col"] == 4
    reset_launches()
    assert launch_counts()["im2col"] == 0
