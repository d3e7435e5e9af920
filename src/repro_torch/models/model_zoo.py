"""Model-zoo facade: ArchConfig -> init / step fns / input specs.

``input_specs(cfg, cell)`` returns stand-ins for every model input of a
shape cell: tensors on the ``meta`` device, which carry a shape and a
dtype and allocate nothing (``repro``'s ``jax.ShapeDtypeStruct``s);
``cache_specs`` and ``param_specs`` build the caches and the parameters on
``meta`` (``repro``'s ``jax.eval_shape``).  Modality frontends (vlm/audio)
are STUBS per the assignment: the specs carry precomputed patch/frame
embeddings instead of pixels/audio.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell, torch_dtype
from .transformer import (decode_step, init_cache, init_lm, lm_forward,
                          lm_loss, prefill)

__all__ = ["init_model", "loss_fn", "prefill_fn", "decode_fn",
           "input_specs", "cache_specs", "param_specs", "model_flops",
           "init_cache", "lm_forward"]

init_model = init_lm
loss_fn = lm_loss
prefill_fn = prefill
decode_fn = decode_step


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, Any]:
    """Stand-ins on ``meta`` for one (arch x shape) cell."""
    b, s = cell.global_batch, cell.seq_len
    d = cfg.d_model
    bf16, i32 = torch.bfloat16, torch.int32
    specs: dict[str, Any] = {}
    if cell.kind == "train":
        if cfg.takes_embeddings:
            specs["embeds"] = _sds((b, s, d), bf16)
        else:
            specs["tokens"] = _sds((b, s), i32)
        if cfg.family == "audio":
            specs["enc_embeds"] = _sds((b, cfg.encoder_len, d), bf16)
        specs["labels"] = _sds((b, s), i32)
    elif cell.kind == "prefill":
        if cfg.takes_embeddings:
            specs["embeds"] = _sds((b, s, d), bf16)
        else:
            specs["tokens"] = _sds((b, s), i32)
        if cfg.family == "audio":
            specs["enc_embeds"] = _sds((b, cfg.encoder_len, d), bf16)
    else:  # decode: one new token against a seq_len-deep cache
        if cfg.takes_embeddings:
            specs["tokens"] = _sds((b, 1, d), bf16)
        else:
            specs["tokens"] = _sds((b, 1), i32)
        specs["pos"] = _sds((), i32)
        specs["cache"] = cache_specs(cfg, b, s)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    dt = torch_dtype(cfg.cache_dtype) if cfg.cache_dtype else torch.bfloat16
    return init_cache(cfg, batch, max_len, dtype=dt, device="meta")


def param_specs(cfg: ArchConfig):
    return init_lm(cfg, 0, device="meta")


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D forward-only (N = active params)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n = cfg.n_active_params()
    mult = 6 if cell.kind == "train" else 2
    return float(mult) * n * tokens
