#!/usr/bin/env python3
"""Which parameter leaves of a reduced zamba2 get no gradient on the card.

    python3 scripts/autograd_witness.py [checkout]

Imports ``repro_torch`` from ``<checkout>/src`` (default: this checkout),
builds the reduced zamba2-2.7b (4 layers, fp32, random weights from seed
0) on the card, takes ``torch.autograd.grad`` of ``lm_loss`` on 2 x 64
tokens with respect to every leaf, and prints the leaves whose gradient
is missing or all zero.  With K4's and K5's autograd Functions none is;
a checkout whose CUDA variants write into tensors without autograd
history leaves the mixers' upstream leaves without one, silently.
Imports nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

CHECKOUT = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(CHECKOUT / "src"))

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import init_model, lm_loss  # noqa: E402


def named_leaves(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def main() -> int:
    if not torch.cuda.is_available():
        print("autograd_witness: no CUDA device is available",
              file=sys.stderr)
        return 1
    cfg = reduced(ARCHS["zamba2-2.7b"], n_layers=4)
    params = init_model(cfg, 0, device="cuda")
    flat = named_leaves(params)
    live = [t.detach().requires_grad_() for _, t in flat]
    tree = rebuild(params, iter(live))
    g = torch.Generator("cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=g)
    loss = lm_loss(cfg, tree, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    missing = [name for (name, _), gr in zip(flat, grads)
               if gr is None or not bool(gr.abs().max() > 0)]
    print(f"{CHECKOUT}: {len(missing)} of {len(flat)} leaves without a "
          f"gradient: {missing}; card {torch.cuda.get_device_name(0)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
