"""Synergy serving engine demo on the card: the paper's inter-frame
pipeline (C4) + work-stealing-style balancing (C3) at REQUEST granularity.

Stages (threads + mailboxes, exactly the paper's producer/consumer layout):
  tokenize(stub) -> prefill (big GEMM jobs) -> decode xN (small jobs)
  -> detokenize(stub)

Prefill and decode are the heterogeneous job mix the Synergy scheduler
balances: prefill jobs are compute-heavy tiles, decode jobs are
memory-bound tiles.  On the card the prefill's attention runs on the
flash-attention kernel (K4) and the GEMMs on the fp32 tile kernel (K1).
A StragglerRebalancer shifts the request share between two decode
"clusters" (replica groups), emulating a degraded replica.  On the card
the script ends by serving the same weights and prompts on the CPU,
where every kernel is its plain version, and holds each request's tokens
against it.

    PYTHONPATH=src python examples_torch/serve_pipeline.py [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.pipeline import ThreadedPipeline  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_model, prefill)
from repro_torch.runtime import StragglerRebalancer  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

DECODE_TOKENS = 8
PROMPT = 32
N_REQ = 12
CFG = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=64)


def default_prompts(dev, n_req: int = N_REQ) -> dict:
    """Request id -> its (1, PROMPT) tokens, drawn on ``dev`` from a
    generator seeded with the request id."""
    return {rid: torch.randint(
        0, CFG.vocab_size, (1, PROMPT), device=dev,
        generator=torch.Generator(device=dev).manual_seed(rid))
        for rid in range(n_req)}


def rebalance(n_req: int) -> list:
    """Twelve between-step observations of two decode replicas, B at half
    speed: ``(step, shares, jobs split)`` every third step."""
    rb = StragglerRebalancer(2, ema=0.5)
    shares = rb.shares
    rows = []
    for step in range(12):
        t_a = shares[0] / 1.0
        t_b = shares[1] / 0.5          # replica B at half speed
        shares = rb.observe([t_a, t_b])
        if step % 3 == 2:
            rows.append((step, list(shares), list(rb.split_jobs(n_req))))
    return rows


def run(device="cuda", *, params: dict | None = None,
        prompts: dict | None = None, n_req: int = N_REQ) -> dict:
    """Serve ``n_req`` requests through the four-stage pipeline.
    ``params`` (on ``device``) default to ``init_model``'s from seed 0;
    ``prompts`` (request id -> (1, PROMPT) tokens) to
    :func:`default_prompts`.  Returns every printed figure and each
    request's tokens."""
    dev = resolve_device(device)
    cfg = CFG
    if params is None:
        params = init_model(cfg, 0, device=dev)
    if prompts is None:
        prompts = default_prompts(dev, n_req)

    def stage_tokenize(req_id):
        return req_id, torch.as_tensor(prompts[req_id]).to(dev)

    def stage_prefill(item):
        req_id, toks = item
        with torch.no_grad():
            logits = prefill(cfg, params, tokens=toks)
        first = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        cache = init_cache(cfg, 1, PROMPT + DECODE_TOKENS + 1, device=dev)
        return req_id, first, cache

    def stage_decode(item):
        req_id, tok, cache = item
        out = [int(tok[0, 0])]
        with torch.no_grad():
            for i in range(DECODE_TOKENS):
                logits, cache = decode_step(cfg, params, cache, tok,
                                            PROMPT + i)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                    torch.int32)
                out.append(int(tok[0, 0]))
        return req_id, out

    def stage_detok(item):
        req_id, toks = item
        return req_id, " ".join(map(str, toks))

    pipe = ThreadedPipeline([
        ("tokenize", stage_tokenize),
        ("prefill", stage_prefill),
        ("decode", stage_decode),
        ("detok", stage_detok),
    ], mailbox_capacity=4)
    outs, stats = pipe.run(list(range(n_req)))
    return {
        "device": device_label(dev), "n_req": n_req,
        "served": len(outs), "fps": stats["fps"], "wall_s": stats["wall_s"],
        "stage_utilization": stats["stage_utilization"],
        "tokens": {rid: [int(t) for t in text.split()] for rid, text in outs},
        "sample": outs[0][1],
        "rebalance": rebalance(n_req),
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, prompts = init_model(CFG, 0, device=dev), default_prompts(dev)
    host = tree_map(lambda t: t.to("cpu", copy=True),
                    {"params": params, "prompts": prompts})
    out = run(dev, params=params, prompts=prompts)
    print(f"served {out['served']} requests at {out['fps']:.1f} req/s "
          f"(wall {out['wall_s']:.2f}s) on {out['device']}")
    for name, u in out["stage_utilization"].items():
        print(f"  stage {name:<9s} utilization {u:5.1%}")
    print("sample:", out["sample"])
    print("\nstraggler rebalancing (replica B degraded 2x):")
    for step, shares, counts in out["rebalance"]:
        print(f"  step {step}: shares A={shares[0]:.2f} "
              f"B={shares[1]:.2f} -> jobs {counts}")

    failures = []
    if sorted(out["tokens"]) != list(range(out["n_req"])):
        failures.append(f"requests served {sorted(out['tokens'])}, not each "
                        f"of {out['n_req']} once")
    if any(len(t) != DECODE_TOKENS + 1 for t in out["tokens"].values()):
        failures.append("a request did not get all its tokens")
    if any(sum(c) != out["n_req"] for _, _, c in out["rebalance"]):
        failures.append("a rebalanced split lost a request")
    if dev.type == "cuda":
        ref = run("cpu", **host)
        differ = sorted(rid for rid in ref["tokens"]
                        if out["tokens"].get(rid) != ref["tokens"][rid])
        print(f"the same weights and prompts on the CPU (plain versions): "
              f"every request's tokens equal: {not differ}")
        if differ:
            failures.append(f"requests {differ} got other tokens on the "
                            f"card than on the CPU")
    print(json.dumps({"example": "serve_pipeline",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
