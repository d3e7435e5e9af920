#!/usr/bin/env python3
"""How far two correct bf16 prefills of zamba2 drift apart at full depth.

    python3 scripts/lm_bf16_divergence.py [--device cpu]

Runs zamba2-2.7b at all 54 layers but a narrow width (d_model 256, 4 heads,
random weights from a seed, param fp32, compute bf16) on 2 x 256 tokens
and prints, as JSON lines, the ``rel_err`` (max |diff| / max |ref|) of the
last-token logits against the prefill with ``impl="ref"`` (both oracles)
when one thing changes:

1. ``p_rounded``: attention with p rounded to bf16 before the PV product
   (what the flash-attention kernel does), the SSD oracle kept;
2. ``ssd_chunked``: the chunked SSD path in place of the recurrence (both
   fp32 here, ~1e-6 apart per call), the attention oracle kept;
3. ``embed_perturbed``: the embeddings scaled by 1 + 1e-3·N(0, 1);
4. ``fp32``: the same weights with compute fp32;
5. ``p_rounded`` again at 6, 18 and 36 layers.

It shows why ``chip_smoke.py`` does not hold the bf16 prefill logits to
3e-2: at 54 layers any last-bit difference grows by orders of magnitude.
Runs on the card; ``--device cpu`` runs it on the CPU, in under a minute.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engines import register_op_impl  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked, ssd_ref  # noqa: E402
from repro_torch.models import init_model, prefill_fn  # noqa: E402
from repro_torch.quant import rel_err  # noqa: E402


def attention_p_rounded(q, k, v, causal: bool):
    """Causal GQA attention in fp32 with p rounded to v's dtype before the
    PV product and l summed from the unrounded p."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    if causal:
        keep = torch.ones((s, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - s)
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(dim=-1, keepdim=True)).reshape(b, hq, s, d).to(q.dtype)


def register_variants() -> None:
    """Two op variants that change one engine each against 'ref'."""
    register_op_impl("attention_scores", "p_rounded",
                     lambda q, k, v, *, causal, blk_q, blk_k:
                     attention_p_rounded(q, k, v, causal), override=True)
    register_op_impl("ssd", "p_rounded",
                     lambda xdt, dta, bm, cm, *, chunk:
                     ssd_ref(xdt, dta, bm, cm), override=True)
    register_op_impl("attention_scores", "ssd_chunked",
                     lambda q, k, v, *, causal, blk_q, blk_k:
                     attention_ref(q, k, v, causal=causal), override=True)
    register_op_impl("ssd", "ssd_chunked",
                     lambda xdt, dta, bm, cm, *, chunk:
                     ssd_chunked(xdt, dta, bm, cm, chunk=chunk),
                     override=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    register_variants()
    cfg = dataclasses.replace(ARCHS["zamba2-2.7b"], d_model=256, n_heads=4,
                              n_kv_heads=4, d_ff=1024, vocab_size=2048)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(device)

    def prefill(c, params, impl):
        return prefill_fn(c, params, tokens=tokens, impl=impl)

    params = init_model(cfg, 0, device=device)
    ref = prefill(cfg, params, "ref")
    rows = {"p_rounded": prefill(cfg, params, "p_rounded"),
            "ssd_chunked": prefill(cfg, params, "ssd_chunked"),
            "fp32": prefill(dataclasses.replace(cfg, compute_dtype="float32"),
                            params, "ref")}
    g = torch.Generator(device=device).manual_seed(5)
    noisy = dict(params, embed=params["embed"] * (1 + 1e-3 * torch.randn(
        params["embed"].shape, generator=g, device=device)))
    rows["embed_perturbed"] = prefill(cfg, noisy, "ref")
    for name, logits in rows.items():
        print(json.dumps({"layers": cfg.n_layers, "change": name,
                          "rel_err_vs_ref": rel_err(logits, ref),
                          "device": str(device)}), flush=True)
    for n_layers in (6, 18, 36):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        p = init_model(c, 0, device=device)
        print(json.dumps({"layers": n_layers, "change": "p_rounded",
                          "rel_err_vs_ref": rel_err(
                              prefill(c, p, "p_rounded"),
                              prefill(c, p, "ref")),
                          "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
