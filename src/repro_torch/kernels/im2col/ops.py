"""Checked wrapper of the CUDA ``im2col`` kernel: the lowering of a CONV
to a GEMM on the card.  Call sites go through
:func:`repro_torch.core.im2col.im2col`, which takes this for a CUDA tensor
and the plain version (:func:`~.ref.im2col_ref`) for any other.

The wrapper launches the kernel or raises: it takes CUDA tensors only, of
rank 4 and of a dtype in :data:`DTYPES`.  ``im2col_cuda.launches`` counts
kernel launches and nothing else, under the lock the other kernels'
counts use."""

from __future__ import annotations

import torch

from repro_torch.kernels.common.gemm import _INT_MAX, count_launch

from .im2col import access_rule, load_im2col
from .ref import conv_out_shape

__all__ = ["DTYPES", "im2col_cuda"]

#: the dtypes the kernel copies: it moves bytes, 4, 2 or 1 an element
DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def im2col_cuda(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x: (N, H, W, C) on the card -> patches (N, OH*OW, KH*KW*C), bitwise
    :func:`~.ref.im2col_ref`, written by one launch on the current
    stream."""
    if x.dim() != 4:
        raise ValueError(f"im2col: need x (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"im2col: x's dtype {x.dtype} not in "
                        f"{list(DTYPES)}")
    if x.device.type != "cuda":
        raise ValueError(f"im2col: no kernel for device {x.device}")
    if min(kh, kw, stride) < 1 or padding < 0:
        raise ValueError(f"im2col: need kernel and stride >= 1 and padding "
                         f">= 0, got kh={kh} kw={kw} stride={stride} "
                         f"padding={padding}")
    n, h, w, c = x.shape
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding)
    if oh < 1 or ow < 1:
        raise ValueError(f"im2col: a {kh}x{kw} window does not fit x "
                         f"{tuple(x.shape)} padded by {padding}")
    k = kh * kw * c
    if (max(n * oh * ow, k, (h + 2 * padding) * (w + 2 * padding) * c)
            > _INT_MAX or max(kh, kw) >= 1 << 15):
        raise ValueError(f"im2col: x {tuple(x.shape)} with a {kh}x{kw} "
                         f"window exceeds the kernel's int offsets")
    out = torch.empty((n, oh * ow, k), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    size = x.element_size()
    if x.data_ptr() % access_rule(c, k, size):
        x = x.clone()         # a fresh allocation lies on 512 bytes
    entry = load_im2col().im2col
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(x.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw, stride,
                   padding, oh, ow, size, stream)
    if rc != 0:
        raise RuntimeError(f"im2col: kernel launch failed with CUDA error "
                           f"{rc} for x {tuple(x.shape)}, {kh}x{kw} window, "
                           f"stride {stride}, padding {padding}")
    count_launch(im2col_cuda)
    return out


im2col_cuda.launches = 0
