"""Deterministic synthetic data pipeline: token / embedding / frame
streams with background prefetch.

The stream is reproducible from (seed, step) — ``repro``'s numpy stream,
bit for bit — so a restarted job replays the exact same data order (the
fault-tolerance invariant), and an N-deep prefetch thread overlaps host
data generation with device compute.  ``repro`` places each host's shard
of the global batch on a mesh (``shardings=``); here the whole batch goes
to one ``device`` (sharded batches come with the mesh).  Token and label
ids stay int32, as in ``repro``: the embedding lookup indexes with them
directly and the loss converts the labels where ``torch.gather`` needs
int64 (:func:`repro_torch.models.layers.softmax_xent`).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device

__all__ = ["synthetic_batches", "prefetch", "make_batch"]


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ArchConfig, cell: ShapeCell, seed: int, step: int,
               device: str | torch.device | None = None) -> dict[str, Any]:
    """One global batch, deterministic in (seed, step), on ``device``
    (default the card)."""
    dev = resolve_device(device)
    rng = _rng_for(seed, step)
    b, s = cell.global_batch, cell.seq_len
    batch: dict[str, Any] = {}

    def put(name: str, arr: np.ndarray):
        batch[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    # a deterministic LM-able stream: token t+1 derived from t (so the loss
    # is learnable)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1), dtype=np.int32)
    toks[:, 1:] = (toks[:, :-1] * 31 + 7) % max(2, cfg.vocab_size // 4)
    if cfg.takes_embeddings:
        emb = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
        put("embeds", emb.astype(np.float32))
    else:
        put("tokens", toks[:, :-1])
    if cfg.family == "audio":
        enc = rng.standard_normal((b, cfg.encoder_len, cfg.d_model),
                                  dtype=np.float32)
        put("enc_embeds", enc)
    put("labels", toks[:, 1:].astype(np.int32))
    return batch


def synthetic_batches(cfg: ArchConfig, cell: ShapeCell, *, seed: int = 0,
                      start_step: int = 0,
                      device: str | torch.device | None = None
                      ) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, cell, seed, step, device)
        step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (overlap host datagen with device step)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
