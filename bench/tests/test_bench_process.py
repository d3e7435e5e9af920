"""The benchmark as a process: what it imports, its refusal to run
without a card, and (on a machine with a card) each cell's short run."""

import json
import os
import subprocess
import sys
import time

import pytest

import bench_testkit as tk

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _python(code: str) -> list[str]:
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


_PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(tk.BENCH)!r}, {str(tk.ROOT / 'src')!r}]
from benchkit.manifest import Bench
b = Bench({str(tk.ROOT)!r})
"""


def test_the_harness_and_the_program_s_entries_load_no_jax():
    """Everything a run imports, the port's entry points with it: no
    module whose top-level name, compared whole, is JAX's or the JAX
    package's (``repro_torch`` is the program)."""
    loaded = _python(_PRELUDE + """
from benchkit import runner, trace, loop, readers, traffic, rounding
import repro_torch.models.cnn, repro_torch.models.transformer
for w in b.manifest["workloads"]:
    cell = b.cell(w["name"])
    b.driver(cell.driver), b.reference(cell.reference), b.loop(cell.loop)
for m in b.manifest["per_layer"]:
    b.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
""")
    assert "repro_torch" in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_the_references_load_nothing_of_the_program():
    refs = sorted(str(p) for p in (tk.BENCH / "reference").glob("*.py"))
    loaded = _python(f"""
import importlib.util, json, sys
for i, path in enumerate({refs!r}):
    spec = importlib.util.spec_from_file_location(f"ref{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
""")
    assert refs and "torch" in loaded
    bad = [m for m in loaded
           if m.split(".")[0] in FORBIDDEN + ("repro_torch", "benchkit")]
    assert not bad


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(tk.BENCH / "run.py"),
                        "--workload", "alexplus.fp32_b256",
                        "--seed", "3000000019", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=tk.ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "card" in p.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [w["name"] for w in tk.manifest()
                                  ["workloads"]])
def test_a_short_run_of_each_cell_on_the_card(card, cell):
    from benchkit.manifest import Bench
    from benchkit.runner import run_cell
    r = run_cell(Bench(tk.ROOT), cell, 3000000021, 2.0, False,
                 t0=time.perf_counter(), log=lambda msg: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


def test_forbidden_names_are_compared_whole():
    from benchkit.runner import forbidden_modules
    names = ["repro_torch.models.cnn", "jaxtyping", "reprolib", "repro.core",
             "jax", "flax.linen", "torch"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "repro.core"]


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch,
                                                             capsys):
    import types

    from benchkit import runner
    monkeypatch.setattr(runner, "run_cell", lambda *a, **k: {"correct": 1})
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    argv = ["--workload", "w", "--seed", "1", "--seconds", "1"]
    assert runner.main(argv, 0.0, tk.ROOT) == 3
    out = capsys.readouterr()
    assert out.out == "" and "repro" in out.err
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])
    assert runner.main(argv, 0.0, tk.ROOT) == 0
    assert json.loads(capsys.readouterr().out) == {"correct": 1}
