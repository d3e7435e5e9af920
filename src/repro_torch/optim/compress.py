"""Gradient / delta compression: blockwise int8 quantization with error
feedback, ``repro``'s bit for bit (the int8 codes, the scales and the
pads).  ``repro`` uses it in the cross-pod local-SGD synchronizer, which
comes to the port with the mesh; it is available for any explicit
gradient exchange.

Error feedback (Seide et al. 2014): the quantization residual is carried to
the next round so the compression bias vanishes in expectation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

from .adamw import scalar

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "decompress_tree", "init_error_feedback"]

_BLOCK = 256


def _blocked(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK), pad


def quantize_int8(x: torch.Tensor):
    """-> (q int8 blocks, scales fp32, pad).  Blockwise symmetric; round
    half to even, as ``jnp.round``."""
    blocks, pad = _blocked(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) \
        / scalar(127.0, blocks)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def init_error_feedback(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def compress_tree(tree, err):
    """Quantize tree + error feedback -> (quantized tree, new error)."""
    def one(x, e):
        x32 = x.to(torch.float32) + e
        q, s, pad = quantize_int8(x32)
        deq = dequantize_int8(q, s, pad, x.shape)
        return (q, s), x32 - deq

    out = tree_map(one, tree, err)
    return (tree_map(lambda o: o[0], out),
            tree_map(lambda o: o[1], out))


def decompress_tree(qtree, shapes_tree, dtype: torch.dtype = torch.float32):
    def one(ref, qs):
        q, s = qs
        pad = (-ref.numel()) % _BLOCK
        return dequantize_int8(q, s, pad, ref.shape, dtype)

    return tree_map(one, shapes_tree, qtree)
