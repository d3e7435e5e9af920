"""Plain PyTorch version of flash attention (causal or full, GQA): the
counterpart of ``repro``'s ``attention_ref``, the path a CPU tensor takes
through :func:`~.ops.flash_attention_cuda`, and what ``chip_smoke.py``
holds the CUDA kernel against on the card."""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, S, D); k/v (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's dtype,
    computed in fp32 (float64 operands, as gradcheck passes, in float64).
    q-head h reads kv head ``h // (Hq // Hkv)``; the causal mask aligns the
    last query with the last key, as ``repro``'s does (the same as row >=
    col when S == Sk)."""
    b, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(acc).reshape(b, hkv, group, s, d)
    s_mat = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(acc)) * scale
    if causal:
        mask = torch.ones((s, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - s)
        s_mat = s_mat.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s_mat, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc))
    return out.reshape(b, hq, s, d).to(q.dtype)
