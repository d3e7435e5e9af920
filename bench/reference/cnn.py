"""Plain PyTorch reference of the paper's CNNs (Synergy, arXiv:1804.00706,
Table 2), written to the equations of ``repro_torch.models.cnn``: NHWC
activations; a CONV layer is a cross-correlation of its (kh, kw, cin,
cout) weight with zero padding, plus its bias, then ReLU; a pool layer is
a non-overlapping max over size x size windows that crops odd edges; an
FC layer multiplies the (h, w, c)-flattened activations by its (n_in,
n_out) weight and adds its bias, with ReLU on every FC layer but the
last.  Float32 with TF32 off.  Imports nothing but torch.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["logits", "no_tf32"]


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def logits(layers: list, params: dict, x: torch.Tensor,
           cast: Callable | None = None) -> torch.Tensor:
    """x (N, H, W, C) -> logits (N, classes).  ``cast``, where given,
    rounds both operands of every product (the control's precision)."""
    q = cast or (lambda t: t)
    fcs = [i for i, spec in enumerate(layers) if spec[0] == "fc"]
    x = x.to(torch.float32)
    with no_tf32(), torch.no_grad():
        for i, spec in enumerate(layers):
            if spec[0] == "conv":
                _, cout, k, stride, pad = spec
                n, h, w, c = x.shape
                oh = (h + 2 * pad - k) // stride + 1
                ow = (w + 2 * pad - k) // stride + 1
                # columns ordered (c, kh, kw), as the weight below
                cols = F.unfold(q(x).permute(0, 3, 1, 2), k, padding=pad,
                                stride=stride)
                wt = q(params[f"conv{i}_w"]).permute(3, 2, 0, 1)
                y = wt.reshape(cout, c * k * k) @ cols
                y = torch.relu(y + params[f"conv{i}_b"][:, None])
                x = y.reshape(n, cout, oh, ow).permute(0, 2, 3, 1)
            elif spec[0] == "pool":
                size = spec[1]
                n, h, w, c = x.shape
                x = x[:, :h - h % size, :w - w % size]
                x = x.reshape(n, h // size, size, w // size, size,
                              c).amax(dim=(2, 4))
            elif spec[0] == "fc":
                x = q(x.reshape(x.shape[0], -1)) @ q(params[f"fc{i}_w"])
                x = x + params[f"fc{i}_b"]
                if i != fcs[-1]:
                    x = torch.relu(x)
            else:
                raise ValueError(f"unknown layer {spec!r}")
    return x
