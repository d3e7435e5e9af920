"""The port stands alone: no module of src/repro_torch, and none of
chip_smoke.py and the card scripts under scripts/, imports JAX or anything
of the reference package repro."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_the_port_has_modules():
    assert len(FILES) > 10
    assert ROOT / "src" / "repro_torch" / "core" / "serving.py" in FILES
    for mod in ("checkpoint/__init__.py", "checkpoint/checkpoint.py",
                "soc/durable.py", "optim/__init__.py", "optim/adamw.py",
                "optim/adafactor.py", "optim/compress.py", "optim/quant.py",
                "data/__init__.py", "data/pipeline.py", "launch/__init__.py",
                "launch/train.py", "runtime/straggler.py", "tree.py",
                "launch/mesh.py", "launch/sharding.py", "launch/serve.py",
                "launch/pipeline_mode.py", "runtime/local_sgd.py",
                "launch/dryrun.py", "launch/hlo_analysis.py"):
        assert ROOT / "src" / "repro_torch" / mod in FILES, mod


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run_smoke(cwd, script):
    """Run chip_smoke.py as a user would: with no PYTHONPATH set."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real")
    proc = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    import shutil
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
