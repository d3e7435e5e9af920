"""LM assembly for all assigned families.

Families:
  dense   — pre-norm GQA attention + GLU MLP           (internlm2, granite,
            phi3, gemma; vlm backbone = dense over patch embeddings)
  moe     — attention + expert-choice MoE FFN          (dbrx, kimi-k2)
  ssm     — Mamba2 blocks only                         (mamba2-130m)
  hybrid  — Mamba2 backbone + ONE shared attn+MLP block applied every
            ``attn_every`` layers (zamba2 signature)
  audio   — whisper-style encoder-decoder (frontend stubbed to embeddings)

Parameters are nested dicts of tensors with ``repro``'s keys and its
stacked (L, ...) layout, so weights carry across key for key
(:func:`repro_torch.models.params.lm_params_from_jax`); ``repro``'s
``lax.scan`` over the stack is a loop over the layer index here.  Serving
(``prefill``, ``decode_step``, ``prepare_cross_cache``) runs under
``torch.inference_mode``; ``decode_step`` writes the caches in place.
Training rematerializes each scanned block when ``cfg.remat`` is set
(``torch.utils.checkpoint``, where ``repro`` uses ``jax.checkpoint``).

In a step over a mesh (:mod:`repro_torch.models.partition`) the
parameters and caches are this rank's 'model' shards, and the blocks
compute partitioned: the embedding and the head on the vocabulary,
attention on heads (decode on the caches' head-dim slice), the MLP
column- then row-parallel, MoE on experts, Mamba2 on P; ``decode_step``
writes the rank's cache shards in place, and ``lm_loss`` takes the
logits split on the vocabulary.  Under autograd (the train step) the
collectives are differentiated (Megatron's f and g).

A leaf that a data axis splits (FSDP) reaches the model functions as this
rank's shard too, and is gathered over the data axes where it is used
(:func:`~repro_torch.models.partition.gather_for_use`): each scanned
layer's slice inside the block (so a rematerialized block gathers again
when it recomputes, and autograd keeps only the shards), the embedding
and the head at the lookup and the head, the hybrid's shared block once a
step (it is applied every ``attn_every`` layers and not rematerialized:
gathered at each use, autograd would keep one whole copy a use).  A
layer's gradient is reduce-scattered over the data axes in the backward.
At most two layers are whole at once: the current one and the one the
backward recomputes.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core.synergy_mm import synergy_matmul
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map
from .attention import (attention, decode_attend, decode_project_kv,
                        init_attention, is_scalar_pos, project_kv,
                        to_cache_layout)
from .layers import (MetaKey, glu_mlp, init_glu_mlp, normal, rms_norm,
                     softmax_xent)
from .moe import init_moe, moe_ffn
from .partition import (all_gather_dim, copy_to_model, data_gather,
                        gather_for_use, gather_rows, model_axis, own_rows,
                        reduce_from_model, saved_as_model_slice,
                        split_over_data, use_data_gather, use_model_axis)
from .ssm import (init_mamba2, init_mamba2_state, mamba2_block,
                  mamba2_decode_step)

__all__ = ["init_lm", "lm_forward", "lm_loss", "init_cache", "decode_step",
           "prefill", "prepare_cross_cache"]


def _layer_slice(tree, l: int):
    return tree_map(lambda a: a[l], tree)


def _grouped(tree, groups: int):
    return tree_map(
        lambda a: a.reshape((groups, a.shape[0] // groups) + a.shape[1:]),
        tree)


# ---------------------------------------------------------------------------
# block init / forward
# ---------------------------------------------------------------------------

def _ones(lead: tuple, n: int, dtype, g: torch.Generator) -> torch.Tensor:
    return torch.ones((*lead, n), dtype=dtype, device=g.device)


def _init_attn_block(cfg: ArchConfig, g: torch.Generator,
                     cross: bool = False, lead: tuple = ()) -> dict:
    dt = cfg.param_torch_dtype
    hd = cfg.resolved_head_dim
    p = {
        "ln1": _ones(lead, cfg.d_model, dt, g),
        "attn": init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               hd, dt, lead=lead),
        "ln2": _ones(lead, cfg.d_model, dt, g),
    }
    if cross:
        p["ln_x"] = _ones(lead, cfg.d_model, dt, g)
        p["cross"] = init_attention(g, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, dt, lead=lead)
    if cfg.family == "moe":
        p["moe"] = init_moe(g, cfg.d_model, cfg.d_ff, cfg.n_experts, dt,
                            lead=lead)
    else:
        p["mlp"] = init_glu_mlp(g, cfg.d_model, cfg.d_ff, dt, lead=lead)
    return p


def _init_mamba_block(cfg: ArchConfig, g: torch.Generator,
                      lead: tuple = ()) -> dict:
    return {
        "ln": _ones(lead, cfg.d_model, cfg.param_torch_dtype, g),
        "mixer": init_mamba2(g, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                             cfg.ssm_head_dim, cfg.param_torch_dtype,
                             lead=lead),
    }


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


#: When set, ``mixer_probe(kind, out, rerun)`` is called after each
#: sequence mixer of the forward (kind "mamba": a Mamba2 mixer;
#: "attention": a self-attention) with its output and ``rerun(impl)``,
#: which recomputes that mixer from the same input with another op
#: variant.  ``chip_smoke.py`` holds the kernels against their oracles
#: block by block through it.
mixer_probe: Callable | None = None


def _mixed(kind: str, mix: Callable, impl: str) -> torch.Tensor:
    """``mix(impl)``, shown to :data:`mixer_probe` when one is set."""
    out = mix(impl)
    if mixer_probe is not None:
        mixer_probe(kind, out, mix)
    return out


def _attn_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                    causal: bool = True, enc: torch.Tensor | None = None,
                    impl: str = "auto") -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _mixed("attention", lambda i: attention(
        p["attn"], h, causal=causal, impl=i, **_attn_kw(cfg)), impl)
    if enc is not None:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + attention(p["cross"], h, kv_x=enc, causal=False,
                          use_rope=False, impl=impl, **_attn_kw(cfg))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        x = x + moe_ffn(p["moe"], h, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor, act=cfg.act)
    else:
        x = x + glu_mlp(p["mlp"], h, act=cfg.act, d_ff=cfg.d_ff)
    return x


def _mamba_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     impl: str = "auto") -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + _mixed("mamba", lambda i: mamba2_block(
        p["mixer"], h, d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, eps=cfg.norm_eps,
        impl=i), impl)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    dev = resolve_device(device)
    if dev.type == "meta":
        return MetaKey()
    return torch.Generator(device=dev).manual_seed(int(key))


def init_lm(cfg: ArchConfig, key: int | torch.Generator = 0, *,
            device: str | torch.device | None = None) -> dict:
    """Random parameters for ``cfg`` on ``device`` (default the card),
    drawn from ``key``: an int seed, or a ``torch.Generator`` (which then
    decides the device).  Same keys, shapes and dtypes as ``repro``'s
    ``init_lm``; not the same numbers (``jax.random`` cannot be replayed).
    On the ``meta`` device nothing is drawn or allocated: the tree holds
    stand-ins of the same shapes and dtypes."""
    g = _generator(key, device)
    dt = cfg.param_torch_dtype
    n = cfg.n_layers
    params: dict[str, Any] = {
        "embed": normal(g, (cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": _ones((), cfg.d_model, dt, g),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(g, (cfg.d_model, cfg.padded_vocab),
                                   cfg.d_model ** -0.5, dt)
    if cfg.family in ("dense", "moe", "vlm"):
        params["blocks"] = _init_attn_block(cfg, g, lead=(n,))
    elif cfg.family == "ssm":
        params["blocks"] = _init_mamba_block(cfg, g, lead=(n,))
    elif cfg.family == "hybrid":
        params["blocks"] = _init_mamba_block(cfg, g, lead=(n,))
        params["shared"] = _init_attn_block(cfg, g)
    elif cfg.family == "audio":
        params["blocks"] = _init_attn_block(cfg, g, cross=True, lead=(n,))
        params["encoder"] = _init_attn_block(cfg, g,
                                             lead=(cfg.encoder_layers,))
        params["enc_norm"] = _ones((), cfg.d_model, dt, g)
    else:
        raise ValueError(cfg.family)
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _records(x: torch.Tensor, stacked: dict) -> bool:
    """True when autograd records a block applied to ``x`` with the
    ``stacked`` parameters."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad
                               for t in tree_leaves(stacked)))


@contextlib.contextmanager
def _under(axis, gather):
    with use_model_axis(axis), use_data_gather(gather):
        yield


def _scan_blocks(body, x, stacked, n: int, remat: bool = False,
                 path: str = "blocks"):
    """``body`` over the ``n`` stacked layers (the leaves at ``path`` of
    the parameter tree), each layer's slice gathered over the data axes
    just before its block (:func:`gather_for_use`).  With ``remat``, a
    block that autograd records keeps only its input and its shards and
    recomputes its gather and activations in the backward (``repro``'s
    ``jax.checkpoint`` per scanned block), under the 'model' and data
    axes of the forward: autograd runs a CUDA backward on a thread of its
    own, which does not see the caller's :func:`use_model_axis`.  On a
    'model' axis of more than one rank the kept input is this rank's
    slice of it, gathered again where the backward recomputes the block
    (:func:`_saved_input`): the same bits, 1/|model| of the bytes.  Without
    ``remat`` a recorded block would keep its whole layer until the
    backward, so a layout that splits a layer over a data axis is
    refused."""
    records = _records(x, stacked)
    if records and not remat and split_over_data(stacked, path):
        raise ValueError(
            f"remat=False under autograd with {path} split over a data "
            f"axis ({', '.join(split_over_data(stacked, path))}): every "
            f"layer would stay gathered until the backward")
    remat = remat and records
    if remat:
        axes = (model_axis(), data_gather())
        recompute = lambda: (contextlib.nullcontext(), _under(*axes))

    def block(p, h):
        return body(gather_for_use(p, path), h)

    # one unbind per leaf: its backward stacks the n layers' gradients
    # (this rank's shards) once, where a slice per layer would add n
    # zero-padded stacks
    layers = tree_map(torch.unbind, stacked)
    for l in range(n):
        p = tree_map(lambda t: t[l], layers)
        if remat:
            with _saved_input(x, axes[0]):
                x = checkpoint(block, p, x, use_reentrant=False,
                               context_fn=recompute)
        else:
            x = block(p, x)
    return x


def _saved_input(x: torch.Tensor, axis):
    """Where a rematerialized block's checkpoint keeps its input ``x``:
    on a 'model' axis, as this rank's slice of it (every rank holds the
    same stream), gathered again by the recomputation
    (:func:`saved_as_model_slice`); whole otherwise."""
    if axis is None:
        return contextlib.nullcontext()
    return saved_as_model_slice(x, axis)


def _backbone(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
              enc: torch.Tensor | None = None,
              impl: str = "auto") -> torch.Tensor:
    if cfg.family in ("dense", "moe", "vlm"):
        body = lambda p, h: _attn_block_fwd(cfg, p, h, impl=impl)
        x = _scan_blocks(body, x, params["blocks"], cfg.n_layers, cfg.remat)
    elif cfg.family == "ssm":
        body = lambda p, h: _mamba_block_fwd(cfg, p, h, impl=impl)
        x = _scan_blocks(body, x, params["blocks"], cfg.n_layers, cfg.remat)
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        per_group = tree_map(torch.unbind,
                              _grouped(params["blocks"], groups))
        inner = lambda p, h: _mamba_block_fwd(cfg, p, h, impl=impl)
        shared = gather_for_use(params["shared"], "shared")
        for grp in range(groups):
            x = _scan_blocks(inner, x, tree_map(lambda t: t[grp], per_group),
                             cfg.attn_every, cfg.remat)
            # the shared block is applied outside the scan: not remat'd
            x = _attn_block_fwd(cfg, shared, x, impl=impl)
    elif cfg.family == "audio":
        body = lambda p, h: _attn_block_fwd(cfg, p, h, enc=enc, impl=impl)
        x = _scan_blocks(body, x, params["blocks"], cfg.n_layers, cfg.remat)
    return x


def _encode(cfg: ArchConfig, params: dict, enc_embeds: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    body = lambda p, h: _attn_block_fwd(cfg, p, h, causal=False, impl=impl)
    enc = _scan_blocks(body, enc_embeds.to(cfg.compute_torch_dtype),
                       params["encoder"], cfg.encoder_layers, cfg.remat,
                       path="encoder")
    return rms_norm(enc, params["enc_norm"], cfg.norm_eps)


def _head(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
          gather: bool = True) -> torch.Tensor:
    """The vocabulary head -> fp32 logits.  In a mesh step whose head is
    split on the vocabulary over 'model', each rank computes its logit
    columns (x enters partitioned compute: f), which are gathered unless
    ``gather`` is False (the loss takes them split)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = (gather_for_use(params["embed"], "embed").T if cfg.tie_embeddings
         else gather_for_use(params["lm_head"], "lm_head"))
    axis = model_axis()
    split = axis is not None and w.shape[-1] != cfg.padded_vocab
    if split:
        x = copy_to_model(x, axis)
    logits = synergy_matmul(x, w.to(x.dtype), name="lm_head",
                            out_dtype=torch.float32)
    if split and gather:
        logits = all_gather_dim(logits, -1, axis.size, axis.group)
    return logits


def _lookup(cfg: ArchConfig, embed: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``.  In a mesh step whose embedding is split on the
    vocabulary over 'model', each rank looks up the tokens of its range,
    zeros the rest, and the rows are summed over 'model'."""
    axis = model_axis()
    if axis is None or embed.shape[0] == cfg.padded_vocab:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - axis.rank * rows
    mine = (local >= 0) & (local < rows)
    found = embed[torch.where(mine, local, 0)]
    found = torch.where(mine[..., None], found, 0)
    return reduce_from_model(found, axis)


def _embed(cfg: ArchConfig, params: dict, tokens, embeds) -> torch.Tensor:
    if embeds is None:
        embeds = _lookup(cfg, gather_for_use(params["embed"], "embed"),
                         tokens)
    return embeds.to(cfg.compute_torch_dtype)


def lm_forward(cfg: ArchConfig, params: dict, *,
               tokens: torch.Tensor | None = None,
               embeds: torch.Tensor | None = None,
               enc_embeds: torch.Tensor | None = None,
               impl: str = "auto", gather: bool = True) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, padded_vocab) fp32; in a
    mesh step whose head is split on the vocabulary, the rank's columns
    unless ``gather`` (see :func:`_head`)."""
    x = _embed(cfg, params, tokens, embeds)
    enc = (_encode(cfg, params, enc_embeds, impl)
           if cfg.family == "audio" else None)
    x = _backbone(cfg, params, x, enc=enc, impl=impl)
    return _head(cfg, params, x, gather=gather)


def lm_loss(cfg: ArchConfig, params: dict, batch: dict, *,
            impl: str = "auto") -> torch.Tensor:
    """Mean token cross-entropy (z-loss 1e-4) of :func:`lm_forward`'s
    logits.  In a mesh step whose head is split on the vocabulary the
    logits stay split and the loss is vocabulary-parallel
    (:func:`~repro_torch.models.layers.softmax_xent`)."""
    logits = lm_forward(
        cfg, params,
        tokens=batch.get("tokens"),
        embeds=batch.get("embeds"),
        enc_embeds=batch.get("enc_embeds"),
        impl=impl, gather=False)
    return softmax_xent(logits, batch["labels"], z_loss=1e-4,
                        vocab=cfg.padded_vocab)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zeroed decode caches on ``device`` (default the card)."""
    dev = resolve_device(device)
    dtype = dtype or (torch_dtype(cfg.cache_dtype) if cfg.cache_dtype
                      else cfg.compute_torch_dtype)
    hd = cfg.resolved_head_dim if cfg.n_heads else 0

    def kv(n: int, s: int) -> torch.Tensor:
        return torch.zeros((n, batch, cfg.n_kv_heads, s, hd), dtype=dtype,
                           device=dev)

    def mamba_states(n: int) -> dict:
        # SSM states stay in the compute dtype (they concatenate with live
        # activations each step); only attention K/V follow cache_dtype.
        return init_mamba2_state(batch, cfg.d_inner, cfg.ssm_state,
                                 cfg.ssm_head_dim, cfg.compute_torch_dtype,
                                 lead=(n,), device=dev)

    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": kv(cfg.n_layers, max_len), "v": kv(cfg.n_layers, max_len)}
    if cfg.family == "ssm":
        return mamba_states(cfg.n_layers)
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return {"mamba": mamba_states(cfg.n_layers),
                "k": kv(groups, max_len), "v": kv(groups, max_len)}
    if cfg.family == "audio":
        return {"k": kv(cfg.n_layers, max_len), "v": kv(cfg.n_layers, max_len),
                "xk": kv(cfg.n_layers, cfg.encoder_len),
                "xv": kv(cfg.n_layers, cfg.encoder_len)}
    raise ValueError(cfg.family)


@torch.inference_mode()
def prepare_cross_cache(cfg: ArchConfig, params: dict,
                        enc_embeds: torch.Tensor, impl: str = "auto"):
    """Whisper: run the encoder and project per-decoder-layer cross K/V,
    stacked (L, B, Hkv, encoder_len, hd)."""
    enc = _encode(cfg, params, enc_embeds, impl)
    kvs = [project_kv(gather_for_use(_layer_slice(params["blocks"], l)
                                     ["cross"], "blocks/cross"), enc,
                      n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.resolved_head_dim, use_rope=False)
           for l in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _write_token_kv(K, V, kk, vv, l: int, pos) -> None:
    """Insert the new token's K/V (B, Hkv, 1, hd) into layer ``l`` of the
    global (L, B, H, S, hd) caches, in place.

    ``pos`` scalar: every batch row writes at the same position.
    ``pos`` (B,) vector: each slot writes at ITS OWN position; rows with
    ``pos < 0`` keep their cache untouched (inactive / non-target slots —
    the continuous-batching server relies on this to keep live requests'
    cache entries intact during another request's prefill).  Masked rows
    rewrite their current entry, so nothing waits on the host."""
    if is_scalar_pos(pos):
        i = int(pos)
        K[l, :, :, i:i + 1] = kk.to(K.dtype)
        V[l, :, :, i:i + 1] = vv.to(V.dtype)
        return
    p = pos.to(K.device)
    rows = torch.arange(K.shape[1], device=K.device)
    p0 = torch.clamp_min(p, 0)
    keep = (p >= 0)[:, None, None]
    for full, new in ((K, kk), (V, vv)):
        layer = full[l]                                    # (B, H, S, hd)
        cur = layer[rows, :, p0]                           # (B, H, hd)
        layer[rows, :, p0] = torch.where(keep, new[:, :, 0].to(full.dtype),
                                         cur)


def _decode_attn_block_inplace(cfg, p, x, K, V, l, pos, xk=None, xv=None):
    """One decoder block; K/V are the GLOBAL stacked caches."""
    kw = _attn_kw(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kk, vv = decode_project_kv(p["attn"], h, pos,
                               n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim,
                               rope_theta=cfg.rope_theta)
    # in a mesh step, this rank's slice of the caches' head dim
    kk = to_cache_layout(kk, cfg.n_kv_heads, K.shape[-1])
    vv = to_cache_layout(vv, cfg.n_kv_heads, V.shape[-1])
    _write_token_kv(K, V, kk, vv, l, pos)
    x = x + decode_attend(p["attn"], h, K[l], V[l], pos, **kw)
    if xk is not None:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + decode_attend(p["cross"], h, xk, xv, cfg.encoder_len - 1,
                              use_rope=False, **kw)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        # one expert-choice group of the whole batch: in a mesh step whose
        # rows are split over the data axes, every rank's rows
        h = gather_rows(h)
        b = h.shape[0]
        y = moe_ffn(p["moe"], h.reshape(1, b, cfg.d_model), top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor, act=cfg.act)
        x = x + own_rows(y.reshape(b, 1, cfg.d_model))
    else:
        x = x + glu_mlp(p["mlp"], h, act=cfg.act, d_ff=cfg.d_ff)
    return x


def decode_rows_independent(cfg: ArchConfig) -> bool:
    """Whether a decode step's batch rows are independent of one another.
    An expert-choice MoE FFN routes the whole decode batch as one group
    (``_decode_attn_block_inplace``), so its rows choose their experts
    together: a mesh step that splits the rows over the data axes gathers
    the MoE's input rows there, and nothing else (``gather_rows``)."""
    return cfg.family != "moe"


def _decode_mamba_inplace(cfg, p, x, mcache, l, pos=None):
    """Mamba block with an in-place state update into the stacked caches.

    Per-slot ``pos`` (B,) vectors mask the recurrent-state update the same
    way ``_write_token_kv`` masks K/V: rows with ``pos < 0`` keep their
    state untouched (bystander slots during another request's prefill)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    st_old = _layer_slice(mcache, l)
    y, st = mamba2_decode_step(p["mixer"], h, st_old, d_inner=cfg.d_inner,
                               ssm_state=cfg.ssm_state,
                               head_dim=cfg.ssm_head_dim,
                               eps=cfg.norm_eps)
    if pos is not None and not is_scalar_pos(pos):
        keep = pos.to(x.device) >= 0
        st = tree_map(
            lambda new, old: torch.where(
                keep.reshape((-1,) + (1,) * (old.dim() - 1)),
                new.to(old.dtype), old),
            st, st_old)
    tree_map(lambda old, new: old.copy_(new), st_old, st)
    return x + y


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int (or (B, 1, d) embeds for
    frontend archs); pos: scalar cache index, OR a per-slot (B,) vector for
    continuous batching — each slot reads/writes at its own position, and
    slots with ``pos < 0`` are masked out of every cache write (their
    logits are garbage and must be ignored).  Returns
    (logits (B, 1, V), cache): the cache's tensors are updated IN PLACE
    (``repro`` returns new arrays) and returned."""
    if cfg.takes_embeddings and tokens.dim() == 3:
        x = tokens.to(cfg.compute_torch_dtype)
    else:
        x = _lookup(cfg, gather_for_use(params["embed"], "embed"),
                    tokens).to(cfg.compute_torch_dtype)

    def layer(l: int) -> dict:
        return gather_for_use(_layer_slice(params["blocks"], l), "blocks")

    if cfg.family in ("dense", "moe", "vlm"):
        for l in range(cfg.n_layers):
            x = _decode_attn_block_inplace(cfg, layer(l), x, cache["k"],
                                           cache["v"], l, pos)
    elif cfg.family == "ssm":
        for l in range(cfg.n_layers):
            x = _decode_mamba_inplace(cfg, layer(l), x, cache, l, pos)
    elif cfg.family == "hybrid":
        per = cfg.attn_every
        shared = gather_for_use(params["shared"], "shared")
        for grp in range(cfg.n_layers // per):
            for i in range(per):
                l = grp * per + i
                x = _decode_mamba_inplace(cfg, layer(l), x, cache["mamba"],
                                          l, pos)
            x = _decode_attn_block_inplace(cfg, shared, x, cache["k"],
                                           cache["v"], grp, pos)
    elif cfg.family == "audio":
        for l in range(cfg.n_layers):
            x = _decode_attn_block_inplace(
                cfg, layer(l), x, cache["k"], cache["v"], l, pos,
                cache["xk"][l], cache["xv"][l])
    else:
        raise ValueError(cfg.family)

    return _head(cfg, params, x), cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, *,
            tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Prefill forward: full-sequence backbone, last-token logits only
    (sliced BEFORE the vocab head so the (B, S, V) logits tensor never
    materializes at long sequence lengths)."""
    x = _embed(cfg, params, tokens, embeds)
    enc = (_encode(cfg, params, enc_embeds, impl)
           if cfg.family == "audio" else None)
    x = _backbone(cfg, params, x, enc=enc, impl=impl)
    return _head(cfg, params, x[:, -1:, :])
