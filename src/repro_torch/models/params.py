"""Carrying ``repro``'s parameters across: nested dicts of numpy arrays
(``jax.random`` cannot be replayed in torch) become tensors with the same
keys and layouts."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["tensor_from_numpy", "lm_params_from_jax", "train_state_from_jax"]


def tensor_from_numpy(arr, device: torch.device) -> torch.Tensor:
    """An exact copy of ``arr`` on ``device``.  A bfloat16 array (numpy's
    ``ml_dtypes.bfloat16``, which ``torch.tensor`` cannot read) crosses as
    its bits: uint16, viewed as int16, viewed as ``torch.bfloat16``."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _tensors(tree: dict, device) -> dict:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return conv(tree)


def lm_params_from_jax(tree: dict, device: str | torch.device | None = None
                       ) -> dict:
    """Parameters of ``repro.models.init_model`` (a nested dict of arrays,
    handed over as numpy) as tensors on ``device`` (default the card), with
    the same keys, shapes, dtypes and stacked (L, ...) layouts."""
    return _tensors(tree, device)


def train_state_from_jax(state: dict,
                         device: str | torch.device | None = None) -> dict:
    """A train state of ``repro.launch.train.make_train_state`` ({"params",
    "opt", "step"}: AdamW's {"m", "v", "step"} or Adafactor's {"stats",
    "step"}; handed over as numpy) as the port's: tensors on ``device``
    (default the card) with the same keys, the steps 0-dim int32."""
    return _tensors(state, device)
