"""Multi-pod dry run: trace every (arch x shape) cell as one rank of the
production mesh, and record that rank's memory, flops, bytes and
collectives.

Each cell is traced on ``meta`` tensors over a FAKE process group of 256
ranks (``--multipod``: 512), the counterpart of ``repro``'s 512 forced
host devices: the step runs as rank 0 of ``make_production_mesh``, its
state placed as rank 0's shards, under
:func:`~repro_torch.launch.hlo_analysis.analyze_step`.  Nothing is
allocated on any device and nothing is launched; the kernels' wrappers
report their calls from their ``meta`` routes, and the GEMMs take the
engines the card would give them.  Every step computes partitioned over
'model', so the in-block all-reduces, all-to-alls and gathers are
counted as the rank issues them: the train step's forward, the
recomputation of each rematerialized block, and the backward's (f's
all-reduces, the inverse all-to-alls), then its gradients averaged over
the data axes and the optimizer's sums over the axes that split each
leaf; with ``fsdp``, each layer's data shards gathered just before the
layer (again in the recomputation) and reduce-scattered in the
backward.  It runs on any machine, card or not.

A process has one default process group, and ``main()`` starts the fake
one in ITS OWN process: never import this module to run it from tests or
benches (they start their own groups, or none); run it as a process:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multipod] [--out results/dryrun_torch]

Outputs one JSON per cell with ``repro``'s keys where they have a
counterpart: the rank's memory (``argument_size_in_bytes``, its shards of
the state, params or cache plus its inputs; ``output``, ``temp``,
``alias`` and ``peak_memory_in_bytes`` from the trace), the step's
``hlo_accounting`` and ``analyzer_version``; ``trace_s`` in place of
``lower_s``/``compile_s``, and ``kernels``, the calls per kernel.

``memory`` also itemizes the peak, beside ``repro``'s keys:
``peak_phase``, the phase of the step that reached it (``forward``,
``backward``: an autograd node running, the rematerialized blocks'
recomputation among them, or ``optimizer``); ``peak_by_origin``, the
arguments, then what the step had made and kept live at the peak, grouped
by (phase, origin, shape, dtype) — origin the op that made it, or the
collective that filled it (an all-gather's concatenation is an
all-gather) — the largest groups first and the rest as ``other``: their
``bytes`` sum to ``peak_memory_in_bytes`` exactly; and ``phase_peaks``,
the arguments plus the most bytes live in each phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.tree import tree_leaves
from .hlo_analysis import analyze_step
from .mesh import make_production_mesh
from .serve import build_decode_step, build_prefill_step
from .sharding import axes_of, place_tree
from .train import build_train_step

__all__ = ["run_cell", "trace_cell", "shard_bytes", "start_fake_group",
           "main", "ANALYZER_VERSION", "MESH_DEVICE"]

#: the version of the step accounting (``analyze_step``) in the records
ANALYZER_VERSION = 1
#: the production mesh's device type here: one that needs no card
MESH_DEVICE = "cpu"


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank
    0: collectives return at once and move nothing.  It serves the
    mesh's device type and ``meta`` tensors (point-to-point batches look
    their backend up by the tensors' device).  Call it once, before any
    mesh is made."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(f"{MESH_DEVICE}:fake,meta:fake",
                            store=FakeStore(), rank=0, world_size=world)


def shard_bytes(tree, spec_tree, mesh) -> int:
    """The bytes of one rank's shards of ``tree``'s tensors under
    ``spec_tree`` (every rank's are the same size: the rules assign an
    axis only where it divides the dimension)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(spec_tree)):
        split = 1
        for entry in spec:
            for a in axes_of(entry):
                split *= sizes[a]
        total += t.numel() * t.element_size() // split
    return total


def _gb(n: int) -> str:
    return f"{n / 1e9:.3f} GB"


def trace_cell(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """One step of ``cell`` traced as this process's rank of ``mesh``
    (``donate=False``, as ``repro``'s dry run compiles it): the record's
    ``memory``, ``hlo_accounting``, ``analyzer_version``, ``trace_s`` and
    ``kernels``."""
    t0 = time.perf_counter()
    if cell.kind == "train":
        step, (aval, sspecs), (ins, bspecs) = build_train_step(
            cfg, cell, mesh, donate=False)
        args = (place_tree(aval, sspecs, mesh), ins)
        argument = (shard_bytes(aval, sspecs, mesh)
                    + shard_bytes(ins, bspecs, mesh))
    elif cell.kind == "prefill":
        step, (aval, pspecs), (ins, bspecs) = build_prefill_step(
            cfg, cell, mesh)
        args = (place_tree(aval, pspecs, mesh), ins)
        argument = (shard_bytes(aval, pspecs, mesh)
                    + shard_bytes(ins, bspecs, mesh))
    else:
        step, (aval, pspecs), (ins, bspecs) = build_decode_step(
            cfg, cell, mesh, donate=False)
        # the new token goes at the cache's last position (``repro``
        # traces ``pos``; the work does not depend on its value)
        args = (place_tree(aval, pspecs, mesh),
                place_tree(ins["cache"], bspecs["cache"], mesh),
                ins["tokens"], cell.seq_len - 1)
        argument = (shard_bytes(aval, pspecs, mesh)
                    + shard_bytes(ins, bspecs, mesh))
    _, acct = analyze_step(step, *args)
    output = acct.output_bytes + acct.alias_bytes
    memory = {"argument_size_in_bytes": argument,
              "output_size_in_bytes": output,
              "temp_size_in_bytes": max(0, acct.peak_bytes
                                        - acct.output_bytes),
              "alias_size_in_bytes": acct.alias_bytes,
              "peak_memory_in_bytes": argument + acct.peak_bytes,
              # the peak itemized: the arguments, then what the step made
              "peak_phase": acct.peak_phase,
              "peak_by_origin": [{"phase": None, "origin": "arguments",
                                  "shape": None, "dtype": None, "count": None,
                                  "bytes": argument}] + acct.peak_by_origin,
              "phase_peaks": {p: argument + n
                              for p, n in acct.phase_peaks.items()}}
    return {"memory": memory, "hlo_accounting": acct.to_dict(),
            "analyzer_version": ANALYZER_VERSION,
            "trace_s": round(time.perf_counter() - t0, 2),
            "kernels": acct.kernels}


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    cfg = ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    rec: dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "kind": cell.kind}

    if cell.name == "long_500k" and not cfg.sub_quadratic:
        rec.update(status="skipped",
                   reason="full-attention arch: long_500k requires "
                          "sub-quadratic attention (DESIGN.md)")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device_type=MESH_DEVICE)
    rec.update(trace_cell(cfg, cell, mesh))
    mem = rec["memory"]
    # proves it fits (or doesn't): one card holds 80 GB
    print({k: _gb(v) for k, v in mem.items() if isinstance(v, int)})
    print("peak in the", mem["peak_phase"], "phase:", "; ".join(
        f"{g['origin']} {g['shape'] or ''} {g['phase'] or ''} "
        f"{_gb(g['bytes'])}" for g in mem["peak_by_origin"][:4]))
    print({k: rec["hlo_accounting"][k] for k in ("flops", "hbm_bytes")})
    rec["status"] = "ok"
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override key=value (perf iterations, "
                         "e.g. --set param_dtype=int8)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (perf iterations)")
    args = ap.parse_args()

    if args.list:
        for a in ARCHS:
            for s in SHAPES:
                print(a, s)
        return

    assert args.arch and args.shape
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{'2x16x16' if args.multipod else '16x16'}"
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    if args.tag:
        tag += "__" + args.tag
    try:
        start_fake_group(512 if args.multipod else 256)
        rec = run_cell(args.arch, args.shape, args.multipod,
                       overrides=overrides or None)
    except Exception as e:  # record failures — they are bugs to fix
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multipod else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("traceback",)}, indent=1))


if __name__ == "__main__":
    main()
