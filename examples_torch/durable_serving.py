"""Durable serving demo on the card: SIGKILL a serving worker mid-wave,
restore it.

A child process serves a batch of requests on a durable
:class:`~repro_torch.core.serving.SynergyServer` on the card — every
accepted request and every emitted token hits a write-ahead journal
before it is visible, and crash-consistent snapshots land through the
Checkpointer on a step cadence.  The parent SIGKILLs the child
mid-generation (a real kill -9, no cleanup handlers run; the child's CUDA
context dies with it), then calls ``SynergyServer.restore`` on the same
directory, on the card: the latest snapshot loads, the journal suffix
replays (every recomputed token verified bitwise against the record), and
the restored server finishes every request.  The printed streams match a
never-crashed reference exactly — served once, lost never.  The servers'
dispatched GEMMs run on the fp32 tile kernel (K1) on the card; there the
never-crashed reference is also served on the CPU, where every kernel is
its plain version, and the streams are held against it too.

The child also installs :func:`~repro_torch.soc.install_sigterm_drain`, so
a polite ``SIGTERM`` (instead of the demo's ``SIGKILL``) would drain
gracefully: finish live generations, snapshot, close the journal.

    PYTHONPATH=src python examples_torch/durable_serving.py [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, SRC)

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.serving import Request, SynergyServer  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.soc import Durability, RequestJournal  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

N_REQ, NEW_TOKENS, PLEN = 6, 12, 4
KILL_AT_TOKENS = 11
CFG = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=32, n_heads=2,
              d_ff=64, vocab=128)
SERVER_KW = dict(slots=3, max_len=32, prefill_len=PLEN)

#: the worker: a durable server on argv[2] that snapshots every 4 steps and
#: prints a heartbeat per step so the parent can kill it demonstrably
#: mid-wave; it serves the parameters the parent saved in argv[1]
_WORKER = textwrap.dedent("""
    import os, sys
    import torch
    from repro_torch.core.serving import Request, SynergyServer
    from repro_torch.soc import Durability, install_sigterm_drain
    from repro_torch.tree import tree_map

    workdir, device = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.dirname(sys.argv[3]))
    from durable_serving import CFG, N_REQ, NEW_TOKENS, SERVER_KW, prompt
    params = tree_map(lambda t: t.to(device),
                      torch.load(os.path.join(workdir, "params.pt")))
    srv = SynergyServer(CFG, params, **SERVER_KW, device=device,
                        durable=Durability(workdir, snapshot_every=4))
    install_sigterm_drain(srv)        # SIGTERM would drain gracefully...
    for i in range(N_REQ):
        srv.submit(Request(i, prompt(i), max_new_tokens=NEW_TOKENS))
    while srv.step():                 # ...but SIGKILL gets no warning
        print("step", srv.stats.engine_steps, "tokens",
              srv.stats.tokens_out, flush=True)
""")


def prompt(i: int) -> torch.Tensor:
    """Request ``i``'s host tokens: ``arange(PLEN) + 3 i``."""
    return torch.arange(PLEN, dtype=torch.int32) + 3 * i


def reference(params, dev) -> dict:
    """Each request's tokens from a server that never crashed."""
    srv = SynergyServer(CFG, params, **SERVER_KW, device=dev)
    reqs = [Request(i, prompt(i), max_new_tokens=NEW_TOKENS)
            for i in range(N_REQ)]
    for r in reqs:
        srv.submit(r)
    srv.run()
    return {r.rid: list(r.out) for r in reqs}


def run(device="cuda", *, params: dict | None = None,
        workdir: str | None = None) -> dict:
    """Serve in a child, SIGKILL it once it has emitted KILL_AT_TOKENS
    tokens, restore in this process and finish.  ``params`` (on
    ``device``) default to ``init_model``'s from seed 0; ``workdir``
    (the journal and snapshots) to a new temporary directory, removed
    at the end.  Returns every printed figure and the streams."""
    dev = resolve_device(device)
    if params is None:
        params = init_model(CFG, 0, device=dev)
    with tempfile.TemporaryDirectory(prefix="durable-serving-") as tmp:
        workdir = workdir or tmp
        torch.save(tree_map(lambda t: t.cpu(), params),
                   os.path.join(workdir, "params.pt"))
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        child = subprocess.Popen(
            [sys.executable, "-c", _WORKER, workdir, str(dev),
             os.path.abspath(__file__)],
            stdout=subprocess.PIPE, text=True, env=env)
        heartbeats = []
        try:
            for line in child.stdout:          # kill -9 mid-generation
                heartbeats.append(line.strip())
                if ("tokens" in line
                        and int(line.split()[-1]) >= KILL_AT_TOKENS):
                    child.kill()
                    break
        finally:
            child.kill()
            child.wait()
        records, _, torn = RequestJournal.scan(
            os.path.join(workdir, "journal.bin"))

        srv = SynergyServer.restore(
            CFG, params, durable=Durability(workdir, snapshot_every=4),
            **SERVER_KW, device=dev)
        replayed = srv.stats.replayed_tokens
        srv.run()
        got = {rid: list(r.out) for rid, r in
               sorted(srv.restored_requests.items())}
        stats = srv.close()
    return {
        "device": device_label(dev), "workdir": workdir,
        "heartbeats": heartbeats, "returncode": child.returncode,
        "journal_records": len(records), "torn": bool(torn),
        "replayed_before_run": replayed, "streams": got,
        "reference": reference(params, dev),
        "tokens_out": stats.tokens_out,
        "replayed_tokens": stats.replayed_tokens,
        "snapshots": stats.snapshots, "restores": stats.restores,
        "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_model(CFG, 0, device=dev)
    out = run(dev, params=params)
    print(f"== worker serving {N_REQ} requests on {out['device']} into "
          f"{out['workdir']}")
    for line in out["heartbeats"]:
        print("  worker:", line)
    print(f"== worker SIGKILLed (rc={out['returncode']}) — no cleanup ran")
    print(f"== journal: {out['journal_records']} records"
          + (" + torn tail (truncated on restore)" if out["torn"] else ""))
    print("== restoring: latest snapshot + journal-suffix replay")
    print(f"   replayed {out['replayed_before_run']} already-delivered "
          f"tokens (verified bitwise), resuming fresh serving")
    print("== streams after crash + restore vs never-crashed reference:")
    ok = sorted(out["streams"]) == list(range(N_REQ))
    for rid, got in out["streams"].items():
        want = out["reference"][rid]
        ok &= got == want
        print(f"   rid {rid}: {got} "
              f"{'== reference' if got == want else '!= ' + str(want)}")
    print(f"== served exactly once: {ok};  fresh tokens "
          f"{out['tokens_out']}, replayed {out['replayed_tokens']}, "
          f"snapshots {out['snapshots']}, restores {out['restores']}")

    failures = []
    if not ok:
        failures.append("a restored stream differs from the reference")
    if dev.type == "cuda":
        plain = reference(tree_map(lambda t: t.cpu(), params),
                          torch.device("cpu"))
        same = out["streams"] == plain
        print(f"== streams vs the never-crashed reference served on the CPU "
              f"(plain versions): {'equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"the card's streams differ from the CPU's "
                            f"{plain}")
    if out["returncode"] != -9:
        failures.append(f"the worker ended with {out['returncode']}, "
                        f"not SIGKILL")
    print(json.dumps({"example": "durable_serving",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
