"""The check that decides ``correct``, driven through the rest of a run on
the CPU at small sizes with the cells' own limits: the program passes; the
control (the plain reference at the precision just below the
configuration's, in the program's place) fails; and so does each fault
that an inference cell can have, planted in the port underneath the
timed path: half of the batch left out, an answer altered where it is
produced."""

import pytest
import torch

import bench_testkit as tk

CONTROL = {"alexplus.fp32_b256": "tf32", "alexplus.fp32_b1024": "tf32"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tk.small_checkout(tmp_path_factory.mktemp("bench"))


def _failed(result):
    return [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_program_passes(root, cell):
    r = tk.run_small(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_control_fails(root, cell):
    def hook(setup):
        setup.entry = setup.control(CONTROL[cell])
    r = tk.run_small(root, cell, setup_hook=hook)
    assert not r["correct"] and _failed(r), r["checks"]


def _half_batch(fn):
    """The wrapped layer runs on the first half of its batch only; the
    second half's rows repeat the first's."""
    def half(cfg, params, x, *args, **kw):
        y = fn(cfg, params, x[:len(x) // 2], *args, **kw)
        return torch.cat([y, y])
    return half


def _altered(fn):
    """The first row of the wrapped layer's output rolled by one."""
    def altered(*args, **kw):
        y = fn(*args, **kw).clone()
        y[0] = y[0].roll(1, dims=-1)
        return y
    return altered


def _plant(monkeypatch, cell, fault):
    from repro_torch.models import cnn as mod
    monkeypatch.setattr(mod, "cnn_layers", fault(mod.cnn_layers))


@pytest.mark.parametrize("fault", [_half_batch, _altered],
                         ids=["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_a_fault_in_the_timed_path_fails(root, cell, fault, monkeypatch):
    _plant(monkeypatch, cell, fault)
    r = tk.run_small(root, cell)
    assert not r["correct"] and _failed(r), r["checks"]
