"""End-to-end training on the card: data pipeline -> train step over a
one-rank mesh -> checkpointing -> fault-tolerant supervisor.

The step is ``build_train_step`` over ``make_test_mesh(data=1, model=1)``
in a process group of one rank (NCCL on the card, gloo on the CPU),
destroyed at the end.  Its attention runs on the flash-attention kernel
(K4); an SSM ``--arch`` also runs the chunked SSD scan kernel (K5).  The
config sets ``remat=False`` as ``repro``'s script does: the port refuses
that only where a layer is split over a data axis, and a data axis of one
rank splits nothing.  On the card, a run that did not resume ends by
taking its first CPU_STEPS steps again on the CPU from the same state,
where every kernel is its plain version, and holds the card's losses
against them.

Card demo (default):  PYTHONPATH=src python examples_torch/train_lm.py
CPU:                  PYTHONPATH=src python examples_torch/train_lm.py \
                          --device cpu
Resume after crash:   re-run the same command — the supervisor restores
                      the latest atomic checkpoint automatically.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.data import prefetch, synthetic_batches  # noqa: E402
from repro_torch.device import device_label, resolve_device  # noqa: E402
from repro_torch.kernels.launches import launch_counts  # noqa: E402
from repro_torch.launch import (build_train_step, gather_tree,  # noqa: E402
                                make_test_mesh, make_train_state,
                                place_tree)
from repro_torch.launch.mesh import one_rank_group  # noqa: E402
from repro_torch.runtime import run_with_recovery  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

PRESETS = {
    # ~2M params: the smoke run
    "tiny": dict(n_layers=4, d_model=128, n_heads=4, d_ff=512, vocab=2048),
    # ~25M params
    "small": dict(n_layers=8, d_model=384, n_heads=8, d_ff=1536, vocab=8192),
    # ~100M params
    "100m": dict(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                 vocab=32000),
}
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
#: the card's first losses against the CPU's: how many, and the relative
#: tolerance (fp32; the kernels sum in another order than their plain
#: versions)
CPU_STEPS, CPU_TOL = 3, 1e-4


def config(arch: str, preset: str):
    """``arch`` reduced to ``preset``'s widths, with ``remat=False``."""
    return dataclasses.replace(reduced(ARCHS[arch], **PRESETS[preset]),
                               remat=False)


def run(device="cuda", *, arch: str = "granite-3-2b", preset: str = "tiny",
        steps: int = 30, batch: int = 8, seq: int = 128,
        ckpt_dir: str = DEFAULT_CKPT_DIR, ckpt_every: int = 10,
        state: dict | None = None) -> dict:
    """Train to step ``steps``, resuming from ``ckpt_dir``'s latest
    checkpoint if it has one, else from ``state`` (a train state on
    ``device``; default ``make_train_state`` from seed 0).  Returns the
    printed figures, every step's loss and the final state on the host."""
    dev = resolve_device(device)
    cfg = config(arch, preset)
    cell = ShapeCell("train", seq, batch, "train")
    log = []
    with one_rank_group(dev.type):
        mesh = make_test_mesh(data=1, model=1, device_type=dev.type)
        fn, (aval, sspecs), _ = build_train_step(cfg, cell, mesh,
                                                 donate=False)
        ck = Checkpointer(ckpt_dir, keep=2, async_write=True)

        def placed(tree):
            """A state as the step takes it: on the device, placed by its
            specs (a restored state comes back on the host)."""
            return place_tree(tree_map(
                lambda t: t if isinstance(t, DTensor) else t.to(dev), tree),
                sspecs, mesh)

        def run_steps(start, end, state):
            # the state's own counter says where it stands: a resumed run
            # starts where its checkpoint left off, not at the supervisor's
            # first step
            state = placed(state)
            start = max(start, int(state["step"].full_tensor()))
            it = prefetch(synthetic_batches(cfg, cell, seed=0,
                                            start_step=start, device=dev),
                          depth=2)
            for s in range(start, end):
                state, metrics = fn(state, next(it))
                log.append((s + 1, float(metrics["loss"]),
                            float(metrics.get("grad_norm", 0))))
                if (s + 1) % ckpt_every == 0:
                    ck.save(s + 1, gather_tree(state))
            ck.wait()
            return state

        resume = ck.latest_step()
        if resume:
            state = ck.restore(aval)
        elif state is None:
            state = make_train_state(cfg, 0, device=dev)
        state, failures = run_with_recovery(
            steps=steps, run_steps=run_steps, checkpointer=ck,
            state0=state)
        final = tree_map(lambda t: t.cpu(), gather_tree(placed(state)))
    return {
        "device": device_label(dev), "arch": cfg.name, "resumed_from": resume,
        "log": log, "losses": [loss for _, loss, _ in log],
        "final_step": int(final["step"]), "failures": failures,
        "state": final, "launches": launch_counts(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=sorted(ARCHS))
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sizes = dict(arch=args.arch, preset=args.preset, batch=args.batch,
                 seq=args.seq, ckpt_every=args.ckpt_every)
    state = host = None
    if dev.type == "cuda":
        state = make_train_state(config(args.arch, args.preset), 0,
                                 device=dev)
        host = tree_map(lambda t: t.to("cpu", copy=True), state)
    out = run(dev, steps=args.steps, ckpt_dir=args.ckpt_dir, state=state,
              **sizes)
    print(f"{out['arch']} ({args.preset}) on {out['device']}")
    if out["resumed_from"]:
        print(f"resuming from checkpoint step {out['resumed_from']}")
    first = out["log"][0][0] if out["log"] else None
    for step, loss, gnorm in out["log"]:
        if step % 5 == 0 or step == first:
            print(f"step {step:4d}  loss {loss:.4f}  gnorm {gnorm:.3f}")
    print(f"done at step {out['final_step']}; "
          f"{len(out['failures'])} recovered failures")

    failures = []
    if out["final_step"] != args.steps:
        failures.append(f"stopped at step {out['final_step']}, "
                        f"not {args.steps}")
    if not all(math.isfinite(v) for v in out["losses"]):
        failures.append("a loss is not finite")
    if host is not None and out["resumed_from"]:
        print("resumed: the card's first losses are not held against the "
              "CPU")
    elif host is not None:
        with tempfile.TemporaryDirectory(prefix="train-lm-cpu-") as tmp:
            ref = run("cpu", steps=CPU_STEPS, ckpt_dir=tmp, state=host,
                      **sizes)
        pairs = list(zip(out["losses"][:CPU_STEPS], ref["losses"]))
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        print(f"the same state and batches on the CPU (plain versions): the "
              f"first {len(pairs)} losses within {err:.2e} (tol {CPU_TOL:g})")
        if len(pairs) != CPU_STEPS or not err <= CPU_TOL:
            failures.append(f"the card's first losses are {err:.2e} from "
                            f"the CPU's, past {CPU_TOL:g}")
    print(json.dumps({"example": "train_lm",
                      "check": "; ".join(failures) or "passed",
                      "launches": out["launches"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
