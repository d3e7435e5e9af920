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

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs.trace import span

__all__ = ["im2col", "im2col_wave", "conv_out_shape", "conv2d_gemm"]


@functools.lru_cache(maxsize=256)
def _patch_index_grids(oh: int, ow: int, kh: int, kw: int,
                       stride: int) -> tuple[np.ndarray, np.ndarray]:
    """(OH, KH) row and (OW, KW) col gather indices, memoized per geometry
    (a CNN forward calls im2col with the same handful of geometries every
    step).  Treat the returned arrays as read-only: they are shared."""
    i0 = np.arange(oh) * stride
    j0 = np.arange(ow) * stride
    rows = i0[:, None] + np.arange(kh)[None, :]
    cols = j0[:, None] + np.arange(kw)[None, :]
    return rows, cols


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x: (N, H, W, C) -> patches (N, OH*OW, KH*KW*C).

    Spans ``im2col`` and, around the hand-over of the two index grids to
    ``x``'s device (a pageable copy that waits for the stream on the
    card), ``im2col.upload``, which counts ``uploads`` and
    ``upload_bytes``."""
    n, h, w, c = x.shape
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding)
    with span("im2col", device=x.device, kh=kh, kw=kw, stride=stride,
              m=n * oh * ow, k=kh * kw * c):
        if padding:
            x = F.pad(x, (0, 0, padding, padding, padding, padding))
        rows, cols = _patch_index_grids(oh, ow, kh, kw, stride)
        with span("im2col.upload", blocks=True) as upload:
            upload.count(uploads=2, upload_bytes=rows.nbytes + cols.nbytes)
            rows = torch.as_tensor(rows, device=x.device)
            cols = torch.as_tensor(cols, device=x.device)
        patches = x[:, rows]                 # (N, OH, KH, W+2p, C)
        patches = patches[:, :, :, cols]     # (N, OH, KH, OW, KW, C)
        patches = patches.permute(0, 1, 3, 2, 4, 5)  # (N, OH, OW, KH, KW, C)
        return patches.reshape(n, oh * ow, kh * kw * c)


def im2col_wave(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Batched multi-image im2col: x (N, H, W, C) — all frames of a wave
    stacked on the batch axis — to one (N*OH*OW, KH*KW*C) GEMM activation
    panel, from one gather."""
    n = x.shape[0]
    patches = im2col(x, kh, kw, stride, padding)
    return patches.reshape(n * patches.shape[1], patches.shape[2])


def conv_out_shape(h: int, w: int, kh: int, kw: int, stride: int,
                   padding: int) -> tuple[int, int]:
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


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
