#!/usr/bin/env python3
"""The port's dry run over every (arch, shape) cell of ``configs.ARCHS`` x
``configs.SHAPES`` on both production meshes, and the table of its
records.

Each cell runs as ``python -m repro_torch.launch.dryrun`` in a process of
its own (a process has one default group), ``--jobs`` at a time; the
records land in ``--out``, one JSON per cell.  Then PERF.md's table: one
markdown row per (arch, shape) whose cells are ``ok``, each value once
per mesh: the rank's argument and peak GB (a peak above a card's 80 GB
in bold), TFLOP, collective GB and counts by type, the trace seconds,
and the peak itemized: its phase and the two largest groups of what the
step had made and kept live there (``peak_by_origin``: the op or
collective that made them, the shape, how many, GB); the skipped cells
and any other status listed below it; and a last line of JSON with
every record.  Needs no card.

    PYTHONPATH=src python scripts/dryrun_table.py [--jobs 8] \\
        [--out results/dryrun_torch] [--arch A ...] [--shape S ...] \\
        [--mesh 16x16 2x16x16] [--table-only]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402

MESHES = {"16x16": [], "2x16x16": ["--multipod"]}
CARD_GB = 80


def run(cell: tuple, out: str, timeout: int) -> tuple:
    arch, shape, mesh = cell
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out, *MESHES[mesh]],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    return cell, rc, time.perf_counter() - t0


def _gb(n) -> str:
    return f"{n / 1e9:.2f}"


_ABBREV = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
           "all-to-all": "A2A", "collective-permute": "CP"}


def row(arch: str, shape: str, recs: list) -> str:
    """One markdown row of an (arch, shape) cell: each value once per
    mesh, ``a / b``; a peak above one card's memory in bold."""
    def peak(r):
        n = r["memory"]["peak_memory_in_bytes"]
        return f"**{_gb(n)}**" if n > CARD_GB * 1e9 else _gb(n)

    columns = [
        lambda r: _gb(r["memory"]["argument_size_in_bytes"]), peak,
        lambda r: f"{r['hlo_accounting']['flops'] / 1e12:.1f}",
        lambda r: _gb(r["hlo_accounting"]["total_bytes"])]
    kinds = sorted({k for r in recs
                    for k in r["hlo_accounting"]["count_by_type"]})
    counts = []
    for k in kinds:
        n = [str(int(r["hlo_accounting"]["count_by_type"].get(k, 0)))
             for r in recs]
        counts.append(f"{_ABBREV.get(k, k)} "
                      + (n[0] if len(set(n)) == 1 else "/".join(n)))
    cells = [" / ".join(col(r) for r in recs) for col in columns]
    trace = " / ".join(str(r["trace_s"]) for r in recs)
    peaks = " / ".join(itemized(r["memory"]) for r in recs)
    return f"| {arch} | {shape} | {' | '.join(cells)} | " \
        f"{', '.join(counts)} | {trace} | {peaks} |"


def itemized(mem: dict) -> str:
    """The peak's phase and its two largest groups of the step's own
    storages (the arguments have their own column)."""
    made = [g for g in mem["peak_by_origin"]
            if g["origin"] not in ("arguments", "other")][:2]
    return f"{mem['peak_phase']}: " + "; ".join(
        f"{g['origin'].removeprefix('aten.')} "
        f"{'x'.join(map(str, g['shape']))} ×{g['count']} {_gb(g['bytes'])}"
        for g in made)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", nargs="*", default=list(MESHES))
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--table-only", action="store_true")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    cells = [(a, s, m) for a in args.arch for s in args.shape
             for m in args.mesh]
    if not args.table_only:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(args.jobs) as pool:
            for (a, s, m), rc, secs in pool.map(
                    lambda c: run(c, out, args.timeout), cells):
                print(f"{a} {s} {m}: exit {rc} in {secs:.1f} s", flush=True)
        print(f"{len(cells)} cells in {time.perf_counter() - t0:.1f} s with "
              f"{args.jobs} processes", flush=True)
    records, bad, skipped = [], [], []
    print(f"meshes {' / '.join(args.mesh)}; peaks above {CARD_GB} GB "
          f"in bold")
    print("| arch | shape | argument GB | peak GB | TFLOP | collective GB "
          "| collectives | trace s | peak: phase, largest origins (GB) |")
    print("|---|---|---|---|---|---|---|---|---|")
    for a in args.arch:
        for s in args.shape:
            recs = []
            for m in args.mesh:
                path = os.path.join(out, f"{a}__{s}__{m}.json")
                if not os.path.exists(path):
                    rec = {"arch": a, "shape": s, "mesh": m,
                           "status": "missing"}
                else:
                    with open(path) as f:
                        rec = json.load(f)
                    rec.pop("traceback", None)
                records.append(rec)
                recs.append(rec)
            status = {r["status"] for r in recs}
            if status == {"ok"}:
                print(row(a, s, recs))
            elif status == {"skipped"}:
                skipped.append(f"{a} {s}")
                reason = recs[0]["reason"]
            else:
                bad += [f"{r['arch']} {r['shape']} {r['mesh']}: "
                        f"{r['status']} {r.get('error', '')}" for r in recs
                        if r["status"] != "ok"]
    if skipped:
        print(f"skipped ({reason}): " + ", ".join(skipped))
    for line in bad:
        print(line)
    print(json.dumps({"records": records}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
