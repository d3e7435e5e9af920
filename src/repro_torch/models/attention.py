"""Attention: GQA projections (Synergy GEMM jobs) + three score engines,
registered as ``attention_scores`` op variants in
:mod:`repro_torch.engines`:

  * 'cuda'        — the flash-attention CUDA kernel (K4); its plain version
                    on CPU tensors.
  * 'flash_torch' — the same online-softmax tiling as a loop over the
                    valid (q-block, kv-block) pairs in plain torch: the
                    counterpart of ``repro``'s 'flash_xla'.
  * 'ref'         — naive reference (small shapes / oracles only).

GQA is computed grouped — q reshaped to (B, Hkv, group, S, D) — so KV is
never materialized repeated.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.synergy_mm import synergy_matmul
from repro_torch.engines import register_op_impl, resolve_op
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from .layers import init_dense, rope
from .partition import (all_gather_dim, all_reduce_sum, all_to_all_rows,
                        copy_to_model, model_axis, reduce_from_model)

__all__ = ["init_attention", "attention", "decode_attention",
           "decode_attend", "decode_project_kv", "flash_attention_torch",
           "from_cache_layout", "is_scalar_pos", "project_kv",
           "to_cache_layout"]

_NEG = -1e30


def init_attention(g: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int,
                   dtype: torch.dtype = torch.float32, *,
                   lead: tuple = ()) -> dict:
    return {
        "wq": init_dense(g, d_model, n_heads * head_dim, dtype, lead=lead),
        "wk": init_dense(g, d_model, n_kv_heads * head_dim, dtype,
                         lead=lead),
        "wv": init_dense(g, d_model, n_kv_heads * head_dim, dtype,
                         lead=lead),
        "wo": init_dense(g, n_heads * head_dim, d_model, dtype,
                         scale=(n_heads * head_dim) ** -0.5, lead=lead),
    }


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          scale: float | None = None, blk_q: int = 512,
                          blk_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over (q-block, kv-block) tile jobs.

    q (B, Hq, S, D); k/v (B, Hkv, Sk, D).  Non-divisible S/Sk are padded
    internally and masked (whisper's 1500-frame encoder etc.)."""
    b, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    blk_q = min(blk_q, s)
    blk_k = min(blk_k, sk)
    s_orig, sk_valid = s, sk
    if s % blk_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, (-s) % blk_q))
        s = q.shape[2]
    if sk % blk_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, (-sk) % blk_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, (-sk) % blk_k))
        sk = k.shape[2]
    nq, nk = s // blk_q, sk // blk_k
    qg = q.reshape(b, hkv, g, nq, blk_q, d)
    kb = k.reshape(b, hkv, nk, blk_k, d)
    vb = v.reshape(b, hkv, nk, blk_k, d)
    f32 = torch.float32
    rows = torch.arange(blk_q, device=q.device)[:, None]
    cols = torch.arange(blk_k, device=q.device)[None, :]

    # the VALID tile jobs only: fully masked future blocks never run
    blocks = []
    for qi in range(nq):
        n_kv = (min(nk, (qi * blk_q + blk_q + blk_k - 1) // blk_k)
                if causal else nk)
        m = torch.full((b, hkv, g, blk_q, 1), _NEG, dtype=f32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, blk_q, 1), dtype=f32, device=q.device)
        acc = torch.zeros((b, hkv, g, blk_q, d), dtype=f32, device=q.device)
        qcur = qg[:, :, :, qi].to(f32)
        for ki in range(n_kv):
            vcur = vb[:, :, ki]
            sres = torch.einsum("bhgqd,bhkd->bhgqk", qcur,
                                kb[:, :, ki].to(f32)) * scale
            # additive (blk_q, blk_k) penalty for the masked entries
            keep = torch.ones((blk_q, blk_k), dtype=torch.bool,
                              device=q.device)
            if causal:
                keep &= qi * blk_q + rows >= ki * blk_k + cols
            if sk_valid != sk:
                keep &= ki * blk_k + cols < sk_valid
            pen = torch.where(keep, 0.0, _NEG).to(f32)
            sres = sres + pen
            m_new = torch.maximum(m, sres.amax(dim=-1, keepdim=True))
            p = torch.exp(sres - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vcur.dtype).to(f32), vcur.to(f32))
            m = m_new
        blocks.append((acc / torch.clamp_min(l, 1e-30)).to(q.dtype))
    out = torch.stack(blocks, dim=3)              # (B, Hkv, g, nq, blk_q, D)
    return out.reshape(b, hq, s, d)[:, :, :s_orig, :]


register_op_impl(
    "attention_scores", "cuda",
    lambda q, k, v, *, causal, blk_q, blk_k: flash_attention(
        q, k, v, causal=causal, impl="cuda"),
    priority=10)
register_op_impl(
    "attention_scores", "flash_torch",
    lambda q, k, v, *, causal, blk_q, blk_k: flash_attention_torch(
        q, k, v, causal=causal, blk_q=blk_q, blk_k=blk_k),
    priority=0)
register_op_impl(
    "attention_scores", "ref",
    lambda q, k, v, *, causal, blk_q, blk_k: attention_ref(
        q, k, v, causal=causal),
    priority=-10)


def _scores_engine(q, k, v, *, causal, impl, blk_q=512, blk_k=1024):
    return resolve_op("attention_scores", impl)(q, k, v, causal=causal,
                                                blk_q=blk_q, blk_k=blk_k)


def attention(params: dict, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int,
              positions: torch.Tensor | None = None,
              rope_theta: float = 1e4, causal: bool = True,
              kv_x: torch.Tensor | None = None, use_rope: bool = True,
              impl: str = "auto", name: str = "attn") -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross).

    x (B, S, d).  kv_x: source for K/V (cross-attention); defaults to x.
    """
    b, s, _ = x.shape
    # in a mesh step the projections may hold this rank's heads only
    hq = params["wq"].shape[-1] // head_dim
    hkv = params["wk"].shape[-1] // head_dim
    axis = model_axis()
    wk, wv = params["wk"], params["wv"]
    if axis is not None and hq != n_heads:
        # heads split: x (and the cross source) enter partitioned compute
        x = copy_to_model(x, axis)
        kv_x = None if kv_x is None else copy_to_model(kv_x, axis)
        if hkv == n_kv_heads:
            # whole K/V heads that feed this rank's q-heads only: a part
            # of their gradient on each rank
            wk, wv = copy_to_model(wk, axis), copy_to_model(wv, axis)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = synergy_matmul(x, params["wq"], name=f"{name}/wq")
    kk = synergy_matmul(src, wk, name=f"{name}/wk")
    vv = synergy_matmul(src, wv, name=f"{name}/wv")
    q = q.reshape(b, s, hq, head_dim).transpose(1, 2)
    kk = kk.reshape(b, sk, hkv, head_dim).transpose(1, 2)
    vv = vv.reshape(b, sk, hkv, head_dim).transpose(1, 2)
    if axis is not None and hq != n_heads and hkv == n_kv_heads:
        # q-heads split, K/V whole: this rank's q-heads' K/V
        kk, vv = _kv_for_heads(kk, vv, axis.rank * hq, hq,
                               n_heads // n_kv_heads)
    if use_rope:
        pos_q = (positions if positions is not None
                 else torch.arange(s, device=x.device))
        q = rope(q, pos_q[None, None, :], rope_theta)
        kk = rope(kk, torch.arange(sk, device=x.device)[None, None, :],
                  rope_theta)
    # K/V stay at Hkv heads: repro repeats them to q-heads for a 16-way TP
    # mesh, and every score engine here reads kv head h // group, so the
    # result is the same.
    o = _scores_engine(q.contiguous(), kk.contiguous(), vv.contiguous(),
                       causal=causal, impl=impl)
    o = o.transpose(1, 2).reshape(b, s, hq * head_dim)
    return _row_parallel(synergy_matmul(o, params["wo"], name=f"{name}/wo"),
                         hq != n_heads)


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, first: int, count: int,
                  group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads (B, Hkv, S, D) that q-heads ``first`` ..
    ``first + count - 1`` read (q-head h reads kv head h // group): a
    slice of whole groups where the q-heads cover whole groups, else one
    kv head per q-head (``repro`` repeats K/V to the q-heads)."""
    if first % group == 0 and count % group == 0:
        lo = first // group
        return k[:, lo:lo + count // group], v[:, lo:lo + count // group]
    idx = torch.arange(first, first + count, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx)


def _row_parallel(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A row-parallel output projection's result, summed over 'model'
    where its rows were split (in a mesh step): g."""
    axis = model_axis()
    return reduce_from_model(y, axis) if split and axis else y


def project_kv(params: dict, src: torch.Tensor, *, n_kv_heads: int,
               head_dim: int, rope_theta: float = 1e4,
               use_rope: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projection for cache prefill (encoder output or prompt)."""
    b, sk, _ = src.shape
    hkv = params["wk"].shape[-1] // head_dim   # this rank's, in a mesh step
    kk = synergy_matmul(src, params["wk"], name="kv/wk")
    vv = synergy_matmul(src, params["wv"], name="kv/wv")
    kk = kk.reshape(b, sk, hkv, head_dim).transpose(1, 2)
    vv = vv.reshape(b, sk, hkv, head_dim).transpose(1, 2)
    if use_rope:
        kk = rope(kk, torch.arange(sk, device=src.device)[None, None, :],
                  rope_theta)
    return kk, vv


def is_scalar_pos(pos) -> bool:
    """A decode position shared by every slot: a Python int or a 0-d
    tensor (a per-slot position is a (B,) tensor).  A Python int keeps the
    step free of host-device copies."""
    return not torch.is_tensor(pos) or pos.dim() == 0


def _rope_positions(pos, b: int, device) -> torch.Tensor:
    """Broadcastable rope positions for one decode token: scalar ``pos`` ->
    (1, 1, 1); per-slot vector (B,) -> (B, 1, 1).  Negative entries mark
    inactive slots (continuous batching) and are clamped — their output is
    discarded and their cache writes masked."""
    if is_scalar_pos(pos):
        return torch.full((1, 1, 1), int(pos), device=device)
    return torch.clamp_min(pos.to(device), 0).reshape(b, 1, 1)


def _cache_valid_mask(pos, s_max: int, device) -> torch.Tensor:
    """(..., s_max) attention mask over cache positions for scalar or
    per-slot (B,) ``pos``."""
    idx = torch.arange(s_max, device=device)
    if is_scalar_pos(pos):
        return (idx <= int(pos))[None, None, None, None, :]
    return (idx[None, :] <= torch.clamp_min(pos.to(device), 0)[:, None]
            )[:, None, None, None, :]


def decode_project_kv(params: dict, x: torch.Tensor, pos, *,
                      n_kv_heads: int, head_dim: int,
                      rope_theta: float = 1e4, use_rope: bool = True):
    """Project the new token's K/V -> (B, Hkv, 1, hd) each (for in-place
    cache insertion).  ``pos``: scalar or per-slot (B,)."""
    b = x.shape[0]
    hkv = params["wk"].shape[-1] // head_dim   # this rank's, in a mesh step
    kk = synergy_matmul(x, params["wk"], name="attn/wk")
    vv = synergy_matmul(x, params["wv"], name="attn/wv")
    kk = kk.reshape(b, 1, hkv, head_dim).transpose(1, 2)
    vv = vv.reshape(b, 1, hkv, head_dim).transpose(1, 2)
    if use_rope:
        kk = rope(kk, _rope_positions(pos, b, x.device), rope_theta)
    return kk, vv


# ---------------------------------------------------------------------------
# decode in a mesh step: the cache split on head_dim over 'model'
# ---------------------------------------------------------------------------

def to_cache_layout(t: torch.Tensor, heads: int, cache_hd: int
                    ) -> torch.Tensor:
    """One token's per-head vectors (B, h, 1, hd) as this rank computed
    them (its heads, or all ``heads``, at the whole head dim) in the
    decode cache's layout (``cache_pspecs``): all heads at this rank's
    ``cache_hd`` slice of the head dim.  An all-to-all where the heads
    are split too, else a slice; O(B·H·hd) bytes.  Outside a mesh step
    (nothing split) ``t`` itself."""
    b, h, one, hd = t.shape
    if cache_hd == hd and h == heads:
        return t
    axis = model_axis()
    if cache_hd == hd:
        raise ValueError(f"decode cache layout: heads split ({h} of "
                         f"{heads}) with the head dim {hd} whole")
    if h == heads:
        lo = axis.rank * cache_hd
        return t[..., lo:lo + cache_hd]
    parts = t.reshape(b, h, one, axis.size, cache_hd).permute(
        3, 0, 1, 2, 4)
    got = all_to_all_rows(parts.contiguous(), [1] * axis.size,
                          [1] * axis.size, axis.group)
    return got.permute(1, 0, 2, 3, 4).reshape(b, heads, one, cache_hd)


def from_cache_layout(o: torch.Tensor, heads: int, head_dim: int
                      ) -> torch.Tensor:
    """:func:`to_cache_layout` undone: (B, H, 1, cache_hd) of every head
    -> (B, ``heads``, 1, ``head_dim``), this rank's heads (or all) at the
    whole head dim, the layout the output projection's rows are split
    by."""
    b, h, one, cache_hd = o.shape
    if cache_hd == head_dim and h == heads:
        return o
    axis = model_axis()
    if cache_hd == head_dim:
        raise ValueError(f"decode cache layout: heads split ({heads} of "
                         f"{h}) with the head dim {head_dim} whole")
    if h == heads:
        return all_gather_dim(o, -1, axis.size, axis.group)
    parts = o.reshape(b, axis.size, heads, one, cache_hd).permute(
        1, 0, 2, 3, 4)
    got = all_to_all_rows(parts.contiguous(), [1] * axis.size,
                          [1] * axis.size, axis.group)
    return got.permute(1, 2, 3, 0, 4).reshape(b, heads, one, head_dim)


def _attend_cache(q, k_cache, v_cache, valid, *, b, n_heads, n_kv_heads,
                  head_dim, dtype):
    """softmax over the cache of one query token per row -> (B, 1, h*hd)
    in ``dtype``; products of cache-dtype values, fp32 sums.  In a mesh
    step ``q`` (B, h, 1, hd) holds this rank's heads (or all) at the
    whole head dim and the caches every head at this rank's slice of the
    head dim: the scores are partial products over the slice, summed
    over 'model' (O(B·H·S)) before the softmax; p·v is taken on the
    slice, and the output moved back to this rank's heads."""
    hq, cache_hd = q.shape[1], k_cache.shape[-1]
    g = n_heads // n_kv_heads
    qs = to_cache_layout(q, n_heads, cache_hd)
    qg = qs.reshape(b, n_kv_heads, g, 1, cache_hd)
    f32 = torch.float32
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(k_cache.dtype).to(f32),
                     k_cache.to(f32))
    if cache_hd != head_dim:
        s = all_reduce_sum(s, model_axis().group)
    s = s / math.sqrt(head_dim)
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype).to(f32),
                     v_cache.to(f32))
    o = from_cache_layout(o.reshape(b, n_heads, 1, cache_hd), hq, head_dim)
    return o.transpose(1, 2).reshape(b, 1, hq * head_dim).to(dtype)


def decode_attend(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, rope_theta: float = 1e4,
                  use_rope: bool = True, name: str = "attn") -> torch.Tensor:
    """One-token attention against a READ-ONLY cache slice (the new
    token's K/V must already be inserted).  x (B,1,d) -> (B,1,d).
    ``pos``: scalar, or per-slot (B,) vector (continuous batching — each
    slot attends only to its own prefix)."""
    b = x.shape[0]
    s_max = k_cache.shape[2]
    hq = params["wq"].shape[-1] // head_dim    # this rank's, in a mesh step
    q = synergy_matmul(x, params["wq"], name=f"{name}/wq")
    q = q.reshape(b, 1, hq, head_dim).transpose(1, 2)
    if use_rope:
        q = rope(q, _rope_positions(pos, b, x.device), rope_theta)
    o = _attend_cache(q, k_cache, v_cache,
                      _cache_valid_mask(pos, s_max, x.device), b=b,
                      n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, dtype=x.dtype)
    return _row_parallel(synergy_matmul(o, params["wo"], name=f"{name}/wo"),
                         hq != n_heads)


def decode_attention(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, rope_theta: float = 1e4,
                     update_cache: bool = True, use_rope: bool = True,
                     name: str = "attn"):
    """One-token decode with KV cache.

    x (B, 1, d); caches (B, Hkv, S_max, hd); pos scalar (current index).
    Returns (y (B, 1, d), k_cache, v_cache); with ``update_cache`` the new
    token's K/V are written into the caches IN PLACE (repro returns new
    arrays) and the same tensors are returned.
    """
    b = x.shape[0]
    s_max = k_cache.shape[2]
    pos = int(pos)
    q = synergy_matmul(x, params["wq"], name=f"{name}/wq")
    q = q.reshape(b, 1, n_heads, head_dim).transpose(1, 2)
    rope_pos = torch.full((1, 1, 1), pos, device=x.device)
    if use_rope:
        q = rope(q, rope_pos, rope_theta)
    if update_cache:
        kk = synergy_matmul(x, params["wk"], name=f"{name}/wk")
        vv = synergy_matmul(x, params["wv"], name=f"{name}/wv")
        kk = kk.reshape(b, 1, n_kv_heads, head_dim).transpose(1, 2)
        vv = vv.reshape(b, 1, n_kv_heads, head_dim).transpose(1, 2)
        if use_rope:
            kk = rope(kk, rope_pos, rope_theta)
        k_cache[:, :, pos:pos + 1] = kk.to(k_cache.dtype)
        v_cache[:, :, pos:pos + 1] = vv.to(v_cache.dtype)
    g = n_heads // n_kv_heads
    qg = q.reshape(b, n_kv_heads, g, 1, head_dim).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                     k_cache.to(torch.float32)) / math.sqrt(head_dim)
    valid = torch.arange(s_max, device=x.device) <= pos
    s = torch.where(valid[None, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.to(torch.float32))
    o = o.reshape(b, n_heads, 1, head_dim).transpose(1, 2)
    o = o.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return (synergy_matmul(o, params["wo"], name=f"{name}/wo"), k_cache,
            v_cache)

