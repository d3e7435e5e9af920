"""Quickstart on the card: build a tiny LM, inspect its Synergy tile-job
decomposition, train a few steps, decode a few tokens.

The forward's attention runs on the hand-written flash-attention kernel
(``flash_attention``, K4) and the decode steps' GEMMs on the fp32 tile
kernel (``tiled_mm``, K1).  On the card the script ends by running the
same weights and batch on the CPU, where every kernel is its plain
version, and holds the card's losses and greedy tokens against it.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.synergy_mm import SynergyTrace  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.launch import loss_and_grads  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_model, lm_loss)
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CFG = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=64)
#: the card's losses against the CPU's, relative (fp32; the kernels sum
#: in another order than their plain versions)
CPU_TOL = 1e-4


def default_batch(dev) -> dict:
    """{"tokens", "labels"}, (4, 32) each, drawn from a generator on
    ``dev`` seeded 0 for each, so labels equal tokens as in ``repro``'s
    script (one key drawn twice)."""
    return {name: torch.randint(
        0, CFG.vocab_size, (4, 32), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
        for name in ("tokens", "labels")}


def run(device="cuda", *, params: dict | None = None,
        batch: dict | None = None, steps: int = 5,
        decode_tokens: int = 8) -> dict:
    """Trace, train ``steps`` AdamW steps, decode ``decode_tokens`` greedy
    tokens.  ``params`` (on ``device``) default to ``init_model``'s from
    seed 0; ``batch`` to :func:`default_batch`.  Returns every printed
    figure."""
    dev = resolve_device(device)
    cfg = CFG
    if params is None:
        params = init_model(cfg, 0, device=dev)
    if batch is None:
        batch = default_batch(dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    out = {"device": device_label(dev), "arch": cfg.name,
           "params": sum(p.numel() for p in tree_leaves(params))}

    # --- the Synergy view: every GEMM is a tile-job set -------------------
    tr = SynergyTrace()
    with tr.activate(), torch.no_grad():
        lm_loss(cfg, params, batch)
    out["gemms"] = len(tr.jobsets)
    out["tile_jobs"] = tr.num_jobs
    out["gflop"] = tr.total_flops / 1e9
    out["jobsets"] = [(js.layer_id, js.name, js.m, js.n, js.k, js.num_jobs)
                      for js in tr.jobsets]
    out["engines"] = {name: (t.gemms, t.jobs, t.busy_s, t.bytes_moved)
                      for name, t in tr.engine_stats.items()}

    # --- a few train steps -------------------------------------------------
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    opt = adamw_init(params)
    losses = []
    for _ in range(steps):
        loss, grads = loss_and_grads(cfg, params, batch)
        params, opt, _ = adamw_update(opt_cfg, grads, opt, params)
        losses.append(float(loss))
    out["losses"] = losses

    # --- decode -------------------------------------------------------------
    cache = init_cache(cfg, 1, 16, device=dev)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tokens = []
    with torch.no_grad():
        for i in range(decode_tokens):
            logits, cache = decode_step(cfg, params, cache, tok, i)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            tokens.append(int(tok[0, 0]))
    out["greedy"] = tokens
    out["launches"] = launch_counts()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, batch = init_model(CFG, 0, device=dev), default_batch(dev)
    host = tree_map(lambda t: t.to("cpu", copy=True),
                    {"params": params, "batch": batch})
    out = run(dev, params=params, batch=batch)
    print(f"arch={out['arch']} (reduced) params={out['params']:,} "
          f"on {out['device']}")
    print(f"traced {out['gemms']} GEMMs -> {out['tile_jobs']} tile jobs, "
          f"{out['gflop']:.2f} GFLOP per step")
    for layer, name, m, n, k, jobs in out["jobsets"][:4]:
        print(f"  layer {layer:<2d} {name:<22s} "
              f"m={m:<6d} n={n:<6d} k={k:<5d} jobs={jobs}")
    # where the dispatcher routed the work (the unified engine registry)
    for name, (gemms, jobs, busy_s, moved) in out["engines"].items():
        print(f"  engine {name:<10s} gemms={gemms:<3d} jobs={jobs:<5d} "
              f"busy~{busy_s * 1e3:.2f}ms bytes={moved / 1e6:.1f}MB")
    for i, loss in enumerate(out["losses"]):
        print(f"step {i}: loss {loss:.4f}")
    print("greedy decode:", out["greedy"])
    print(f"kernel launches: {out['launches']}")

    failures = []
    losses = out["losses"]
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"a loss is not finite: {losses}")
    elif losses[-1] >= losses[0]:
        failures.append(f"the loss did not decrease: {losses}")
    if dev.type == "cuda":
        ref = run("cpu", **host)
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        same = out["greedy"] == ref["greedy"]
        print(f"the same weights and batch on the CPU (plain versions): "
              f"losses within {err:.2e} (tol {CPU_TOL:g}), greedy tokens "
              f"equal: {same}")
        if not err <= CPU_TOL:
            failures.append(f"the card's losses are {err:.2e} from the "
                            f"CPU's, past {CPU_TOL:g}")
        if not same:
            failures.append(f"greedy tokens {out['greedy']} on the card, "
                            f"{ref['greedy']} on the CPU")
    print(json.dumps({"example": "quickstart",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
