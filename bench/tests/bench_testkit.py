"""What the benchmark's CPU tests share: the harness on ``sys.path``, and
a throwaway checkout whose cells are small copies of the real ones."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_checkout(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` whose cells run at CPU sizes:
    every mix of batches cut to batches of 4 from a pool of 2; the limits
    are the real cells'."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest()))
    for path in (root / "bench/traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update({"batch": 4, "pool": 2, "warmup_batches": 1})
        path.write_text(json.dumps(mix))
    return root


def run_small(root: Path, workload: str, seed: int = 7,
              setup_hook=None) -> dict:
    """One CPU run of ``workload`` in the small checkout: a window of a
    few batches, no trace."""
    from benchkit.manifest import Bench
    from benchkit.runner import run_cell
    return run_cell(Bench(root), workload, seed, 0.05, False,
                    t0=time.perf_counter(), device="cpu",
                    log=lambda msg: None, setup_hook=setup_hook)
