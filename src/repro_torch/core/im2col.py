"""im2col: data-layout transformation turning convolution into GEMM (§3.1.1).

The paper follows Caffe/Darknet: flatten each (kh, kw, cin) receptive field
into a row, so ``conv(x, w)`` becomes ``A[m, k] @ B[k, n]`` with

    m = out_h * out_w          (per image)
    k = kh * kw * cin
    n = cout

Layout is NHWC with (kh, kw, cin) row order, as in ``repro``: the conv
weight reshape and the FC flatten of ``models/cnn.py`` depend on it.
Torch's NCHW ``unfold`` orders K as (cin, kh, kw) and must not be used here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.im2col import conv_out_shape, im2col_cuda, im2col_ref
from repro_torch.obs.trace import span

__all__ = ["im2col", "im2col_wave", "conv_out_shape", "conv2d_gemm"]


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x: (N, H, W, C) -> patches (N, OH*OW, KH*KW*C).

    A CUDA tensor takes the hand-written kernel (``kernels/im2col``: one
    launch writes the patches from ``x``, every index computed on the
    card) or raises; any other takes the plain version (two gathers
    through index grids handed to ``x``'s device, span
    ``im2col.upload``).  The two give the same bits.

    Spans ``im2col``, which counts ``im2col_launches`` on the card."""
    n, h, w, c = x.shape
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding)
    with span("im2col", device=x.device, kh=kh, kw=kw, stride=stride,
              m=n * oh * ow, k=kh * kw * c) as s:
        if x.device.type != "cuda":
            return im2col_ref(x, kh, kw, stride, padding)
        patches = im2col_cuda(x, kh, kw, stride, padding)
        s.count(im2col_launches=1)
        return patches


def im2col_wave(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Batched multi-image im2col: x (N, H, W, C) — all frames of a wave
    stacked on the batch axis — to one (N*OH*OW, KH*KW*C) GEMM activation
    panel, from one gather."""
    n = x.shape[0]
    patches = im2col(x, kh, kw, stride, padding)
    return patches.reshape(n * patches.shape[1], patches.shape[2])


def conv2d_gemm(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0, matmul=None) -> torch.Tensor:
    """Convolution via im2col + GEMM (the Synergy CONV path).

    x: (N, H, W, Cin); w: (KH, KW, Cin, Cout) -> (N, OH, OW, Cout).
    ``matmul`` lets callers route the GEMM through ``synergy_matmul`` (tile
    jobs); defaults to torch.matmul.
    """
    kh, kw, cin, cout = w.shape
    n, h, wd, _ = x.shape
    oh, ow = conv_out_shape(h, wd, kh, kw, stride, padding)
    a = im2col(x, kh, kw, stride, padding)          # (N, OH*OW, K)
    b = w.reshape(kh * kw * cin, cout)              # (K, Cout)
    mm = matmul if matmul is not None else torch.matmul
    out = mm(a.reshape(n * oh * ow, -1), b)         # (N*OH*OW, Cout)
    return out.reshape(n, oh, ow, cout)
