"""The port's ``Checkpointer`` (``repro_torch.checkpoint``) on the CPU:
``tests/test_checkpoint.py``'s roundtrip, async write, retention,
atomicity, stale-``.tmp`` cleanup and recovery loop, plus what the port
adds — bf16 leaves bitwise, a save that is a copy (an in-place write after
an async save does not reach the file), and directories that ``repro``'s
``Checkpointer`` and the port's read from each other.  Tolerance: bitwise
everywhere."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime import run_with_recovery

TIMEOUT = 60


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": torch.ones(8, 8),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    state = _state()
    ck.save(7, state)
    restored = ck.restore(state)
    assert restored.keys() == state.keys()
    for a, b in zip(_leaves(state), _leaves(restored)):
        _bitwise(a, b)
    assert ck.last_bytes == sum(t.numel() * t.element_size()
                                for t in _leaves(state))


def test_roundtrip_of_lists_tuples_and_scalars(tmp_path):
    """Sequences come back as sequences of their own type; numpy arrays
    and Python scalars as tensors of their dtype."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    state = {"seq": [torch.arange(3), (np.float32(1.5), 2)],
             "arr": np.arange(6, dtype=np.int32).reshape(2, 3)}
    ck.save(1, state)
    got = ck.restore(state)
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    assert torch.equal(got["seq"][0], torch.arange(3))
    assert got["seq"][1][0].dtype == torch.float32
    assert got["seq"][1][0].item() == 1.5 and got["seq"][1][1].item() == 2
    assert torch.equal(got["arr"], torch.from_numpy(state["arr"]))


def test_async_write_and_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(1, _state())
    ck.wait()
    assert ck.latest_step() == 1
    assert ck.copy_s > 0.0


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]


def test_no_tmp_left_behind(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(5, _state())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_stale_tmp_gc_on_open(tmp_path):
    """A process killed mid-save leaves ``step_N.tmp`` behind; the next
    Checkpointer on the directory sweeps it (and ``all_steps`` never
    reports it), or the orphan would block a later save of the same
    step."""
    stale = tmp_path / "step_00000099.tmp"
    stale.mkdir()
    (stale / "half_written.npy").write_bytes(b"\x93NUMPY garbage")
    # a *file* named like a snapshot dir must not crash the scan either
    (tmp_path / "step_00000001").write_bytes(b"not a dir")
    ck = Checkpointer(str(tmp_path), async_write=False)
    assert not stale.exists()
    assert ck.all_steps() == []
    ck.save(99, _state())                   # the once-blocked step saves
    assert ck.latest_step() == 99
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_run_with_recovery_resumes(tmp_path):
    """A failure at step 6: the supervisor restores step 5 and completes
    all 10 steps with the arithmetic intact."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    state0 = {"x": torch.tensor(0.0), "step": torch.tensor(0, dtype=torch.int32)}
    fail_once = {"armed": True}

    def run_steps(start, end, state):
        for s in range(start, end):
            if s == 6 and fail_once["armed"]:
                fail_once["armed"] = False
                raise RuntimeError("simulated node failure")
            state = {"x": state["x"] + 1.0,
                     "step": torch.tensor(s + 1, dtype=torch.int32)}
            if (s + 1) % 5 == 0:
                ck.save(s + 1, state)
        return state

    final, failures = run_with_recovery(
        steps=10, run_steps=run_steps, checkpointer=ck, state0=state0)
    assert len(failures) == 1
    assert int(final["step"]) == 10
    assert float(final["x"]) == 10.0


def test_bf16_roundtrip_is_bitwise(tmp_path):
    """numpy has no bfloat16: the 16-bit pattern goes to disk as uint16
    and comes back bit for bit, signed zeros, infinities and NaN payloads
    included."""
    g = torch.Generator().manual_seed(3)
    bits = torch.randint(-2 ** 15, 2 ** 15, (257,), dtype=torch.int32,
                         generator=g).to(torch.int16)
    special = torch.tensor([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0x0001],
                           dtype=torch.int32).to(torch.int16)
    x = torch.cat([bits, special]).view(torch.bfloat16)
    state = {"x": x, "y": torch.randn(4, 3, generator=g).to(torch.bfloat16)}
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, state)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        manifest = json.load(f)["arrays"]
    assert manifest["x"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000001" / "x.npy").dtype == np.uint16
    got = ck.restore(state)
    for k in state:
        _bitwise(got[k], state[k])


def test_async_save_is_a_copy(tmp_path):
    """``save`` copies before it returns: an in-place write to the saved
    tensor while the writer thread has not yet run does not reach the
    checkpoint (the server writes its caches in place every step)."""
    ck = Checkpointer(str(tmp_path), async_write=True)
    go = threading.Event()
    write = ck._write

    def gated(step, host):
        assert go.wait(TIMEOUT)
        write(step, host)

    ck._write = gated
    state = {"cache": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "half": torch.ones(5, dtype=torch.bfloat16)}
    saved = {k: v.clone() for k, v in state.items()}
    ck.save(1, state)
    state["cache"].add_(100.0)            # the next step, in place
    state["half"].mul_(3.0)
    go.set()
    ck.wait()
    got = ck.restore(state)
    for k in state:
        _bitwise(got[k], saved[k])


def test_writer_errors_surface_on_wait(tmp_path):
    """A failed async write is raised by the next ``wait`` (and so by the
    next ``save``), never lost on the writer thread."""
    ck = Checkpointer(str(tmp_path), async_write=True)

    def broken(step, host):
        raise OSError("disk full")

    ck._write = broken
    ck.save(1, _state())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                              # raised once


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_directories_cross_between_repro_and_the_port(tmp_path, writer):
    """A directory written by one package's Checkpointer (fp32 and int32
    leaves, nested keys) restores bitwise through the other's, and both
    write the same manifest keys and file names for the same state."""
    st = _state(5)
    jst = {"params": {"w": jnp.asarray(st["params"]["w"].numpy()),
                      "b": jnp.asarray(st["params"]["b"].numpy())},
           "opt": {"m": jnp.asarray(st["opt"]["m"].numpy()),
                   "step": jnp.int32(7)},
           "step": jnp.int32(7)}
    jdir, tdir = str(tmp_path / "repro"), str(tmp_path / "port")
    JaxCheckpointer(jdir, async_write=False).save(3, jst)
    Checkpointer(tdir, async_write=False).save(3, st)

    def manifest(d):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            return json.load(f)["arrays"]

    assert manifest(jdir) == manifest(tdir)
    if writer == "repro":
        got = Checkpointer(jdir).restore(st)
        for a, b in zip(_leaves(st), _leaves(got)):
            _bitwise(a, b)
    else:
        got = JaxCheckpointer(tdir).restore(jax.eval_shape(lambda: jst))
        for a, b in zip(jax.tree.leaves(jst), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
