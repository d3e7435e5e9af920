"""Multi-tenant QoS demo on the card: the same overloaded 2-tenant request
mix served (a) by the untenanted FIFO server and (b) by the QoS server,
printing each tenant's SLO deadline attainment side by side.

A BULK flood (12 sheddable, undeadlined requests) is submitted AHEAD of
a small GOLD stream (4 interactive requests with a deadline).  FIFO
admits in arrival order, so every gold request waits behind the whole
flood and misses; QoS admission picks gold first (priority 10, weight
4) and its prefill/decode panels carry priority tags through the
work-stealing runtime, so gold meets its deadline while bulk absorbs
the queueing delay.  The servers' dispatched GEMMs run on the fp32 tile
kernel (K1) on the card; the runtime's pool is the paper's simulated
PEs.

The gold deadline is calibrated from this run's wall time, so the
attainment varies from run to run; the admitted requests and the tokens
per tenant and per request do not.  On the card the script ends by
serving the same weights and prompts on the CPU, where every kernel is
its plain version, and holds each request's tokens against it.

    PYTHONPATH=src python examples_torch/multi_tenant.py [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.serving import Request, SynergyServer  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.soc import SynergyRuntime, Tenant  # noqa: E402
from repro_torch.soc.qos import QosClass  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

N_GOLD, N_BULK, SLOTS, PLEN = 4, 12, 2, 8
GOLD = QosClass("gold", priority=10, weight=4.0)
BULK = QosClass("bulk", priority=-10, sheddable=True)
CFG = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=32, n_heads=2,
              d_ff=64, vocab=128)


def prompt(rid: int) -> torch.Tensor:
    """Request ``rid``'s host tokens, from a generator seeded ``rid``."""
    return torch.randint(0, 128, (PLEN,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(rid))


def requests(base, n, tenant, max_new, deadline_s=None, prompts=prompt):
    return [Request(base + i, prompts(base + i), max_new_tokens=max_new,
                    tenant=tenant, deadline_s=deadline_s) for i in range(n)]


def make_server(cfg, params, tenants, dev, prompts):
    rt = SynergyRuntime(["F-PE", "S-PE"], device=dev,
                        name="qos-demo" if tenants else "fifo-demo")
    srv = SynergyServer(cfg, params, slots=SLOTS, max_len=32,
                        prefill_len=PLEN, runtime=rt, tenants=tenants,
                        device=dev)
    warm = "gold" if tenants else None
    for r in requests(900_000, SLOTS, warm, 2, prompts=prompts):   # warm-up
        srv.submit(r)
    srv.run()
    srv.reset_stats()
    return srv, rt


def attainment(gold_reqs):
    hits = sum(1 for r in gold_reqs
               if r.done_at is not None and r.done_at <= r.deadline_at)
    return hits / len(gold_reqs)


def run(device="cuda", *, params: dict | None = None, prompts=prompt,
        n_gold: int = N_GOLD, n_bulk: int = N_BULK) -> dict:
    """The FIFO and QoS servers on the same arrival order.  ``params`` (on
    ``device``) default to ``init_model``'s from seed 0; ``prompts`` maps
    a request id to its tokens.  Returns every printed figure and each
    request's tokens."""
    dev = resolve_device(device)
    if params is None:
        params = init_model(CFG, 0, device=dev)

    # self-calibrate the gold deadline: 1.5x the solo gold makespan
    srv_q, rt_q = make_server(CFG, params, [Tenant("gold", GOLD),
                                            Tenant("bulk", BULK)], dev,
                              prompts)
    try:
        t0 = time.perf_counter()
        for r in requests(800_000, n_gold, "gold", 4, prompts=prompts):
            srv_q.submit(r)
        srv_q.run()
        deadline_s = 1.5 * (time.perf_counter() - t0) + 0.25
        srv_q.reset_stats()

        results, tokens = {}, {}
        # FIFO baseline: no tenancy, arrival order wins
        srv_f, rt_f = make_server(CFG, params, None, dev, prompts)
        try:
            bulk = requests(0, n_bulk, None, 8, prompts=prompts)
            gold = requests(5000, n_gold, None, 4, deadline_s=deadline_s,
                            prompts=prompts)
            for r in bulk + gold:
                srv_f.submit(r)
            srv_f.run()
        finally:
            rt_f.shutdown()
        results["fifo"] = attainment(gold)
        tokens["fifo"] = {r.rid: list(r.out) for r in bulk + gold}

        # QoS: same arrival order, priority admission + tagged panels
        bulk = requests(0, n_bulk, "bulk", 8, prompts=prompts)
        gold = requests(5000, n_gold, "gold", 4, deadline_s=deadline_s,
                        prompts=prompts)
        for r in bulk + gold:
            srv_q.submit(r)
        stats = srv_q.run()
    finally:
        rt_q.shutdown()
    results["qos"] = attainment(gold)
    tokens["qos"] = {r.rid: list(r.out) for r in bulk + gold}
    return {
        "device": device_label(dev), "deadline_s": deadline_s,
        "attainment": results, "tokens": tokens,
        "tenants": {name: {"admitted": ts.admitted,
                           "tokens_out": ts.tokens_out,
                           "queue_wait_s": ts.queue_wait_s,
                           "deadline_hits": ts.deadline_hits,
                           "deadline_misses": ts.deadline_misses}
                    for name, ts in sorted(stats.tenants.items())},
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_model(CFG, 0, device=dev)
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    out = run(dev, params=params)
    print(f"gold SLO deadline (self-calibrated on {out['device']}): "
          f"{out['deadline_s']:.2f}s\n")
    print(f"{'server':<8s} {'gold SLO attainment':>20s}   (bulk has no SLO)")
    for mode, att in out["attainment"].items():
        print(f"{mode:<8s} {att:>20.0%}")
    print("\nper-tenant stats (QoS server):")
    for name, ts in out["tenants"].items():
        print(f"  {name:<6s} admitted={ts['admitted']:<3d} "
              f"tokens={ts['tokens_out']:<4d} "
              f"queue_wait={ts['queue_wait_s']:6.2f}s "
              f"deadline {ts['deadline_hits']}/"
              f"{ts['deadline_hits'] + ts['deadline_misses']} hit")

    same = out["tokens"]["fifo"] == out["tokens"]["qos"]
    print(f"\nthe QoS server's tokens equal the FIFO server's: {same}")

    failures = []
    admitted = {name: ts["admitted"] for name, ts in out["tenants"].items()}
    if admitted != {"bulk": N_BULK, "gold": N_GOLD}:
        failures.append(f"admitted per tenant {admitted}")
    for mode, toks in out["tokens"].items():
        want = {**{i: 8 for i in range(N_BULK)},
                **{5000 + i: 4 for i in range(N_GOLD)}}
        if {rid: len(t) for rid, t in toks.items()} != want:
            failures.append(f"the {mode} server did not answer every "
                            f"request once with all its tokens")
    if dev.type == "cuda":
        ref = run("cpu", params=host)
        differ = {mode: sorted(rid for rid, t in ref["tokens"][mode].items()
                               if out["tokens"][mode].get(rid) != t)
                  for mode in ref["tokens"]}
        print(f"the same weights and prompts on the CPU (plain versions): "
              f"every request's tokens equal: "
              f"{not any(differ.values())}")
        if any(differ.values()):
            failures.append(f"requests got other tokens on the card than "
                            f"on the CPU: {differ}")
    print(json.dumps({"example": "multi_tenant",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
