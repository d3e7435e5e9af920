"""Plain PyTorch version of the im2col kernel: the path a CPU (or ``meta``)
tensor takes, the oracle the CPU tests hold against ``repro``'s im2col,
and what the card tests and ``chip_smoke.py`` hold the CUDA kernel
against, bitwise.

Two gathers through memoized index grids: rows into ``(N, OH, KH, W+2p,
C)``, then columns into ``(N, OH, KH, OW, KW, C)``, permuted and copied
into ``(N, OH*OW, KH*KW*C)``.  The grids are numpy arrays handed to
``x``'s device at every call (span ``im2col.upload``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs.trace import span

__all__ = ["conv_out_shape", "im2col_ref"]


def conv_out_shape(h: int, w: int, kh: int, kw: int, stride: int,
                   padding: int) -> tuple[int, int]:
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


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


def im2col_ref(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """x: (N, H, W, C) -> patches (N, OH*OW, KH*KW*C), in the (kh, kw, cin)
    column order.

    Spans ``im2col.upload`` around the hand-over of the two index grids
    to ``x``'s device, which counts ``uploads`` and ``upload_bytes``."""
    n, h, w, c = x.shape
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding)
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
