"""Model-zoo facade: ArchConfig -> init / step fns / MODEL_FLOPS.

``repro``'s ``input_specs``/``cache_specs``/``param_specs`` are dry-run
stand-ins built on ``jax.eval_shape``; they come with the launch slice.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell
from .transformer import (decode_step, init_cache, init_lm, lm_forward,
                          lm_loss, prefill)

__all__ = ["init_model", "loss_fn", "prefill_fn", "decode_fn", "model_flops",
           "init_cache", "lm_forward"]

init_model = init_lm
loss_fn = lm_loss
prefill_fn = prefill
decode_fn = decode_step


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D forward-only (N = active params)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n = cfg.n_active_params()
    mult = 6 if cell.kind == "train" else 2
    return float(mult) * n * tokens
