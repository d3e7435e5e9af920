"""Atomic, async checkpointing — the restart half of fault tolerance.

Layout (``repro``'s, file for file): ``<dir>/step_<N>/`` holding one
``.npy`` per leaf plus ``manifest.json`` (each leaf's key, file, shape and
dtype).  Writes go to ``step_<N>.tmp`` and are atomically renamed — a
crashed writer never corrupts the latest checkpoint.  ``save`` can run on
a background thread (``async_write=True``) double-buffering against
serving or training.

A state is a tree of nested dicts, lists and tuples whose leaves are
tensors (on any device), numpy arrays or Python scalars.  A leaf's key is
its path joined by ``.`` (dict keys in sorted order, list and tuple
positions as numbers) — the key ``repro``'s ``Checkpointer`` gives the same
leaf of a string-keyed tree, so each reads the other's directories.
numpy has no bfloat16: a bf16 tensor is stored as its 16-bit pattern
(``uint16``) with ``"dtype": "bfloat16"`` in the manifest and viewed back
on load, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Checkpointer"]

_BF16 = "bfloat16"


def _flatten(tree, path: tuple = ()):
    """``(path, leaf)`` pairs: dict keys sorted, sequences by position,
    ``None`` an empty subtree (jax's pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _rebuild(like, leaf, path: tuple = ()):
    """``like``'s structure with each leaf replaced by ``leaf(path)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf, path + (i,))
                          for i, v in enumerate(like))
    return None if like is None else leaf(path)


def _key_str(path: tuple) -> str:
    return ".".join(str(p) for p in path)


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A host array that shares no memory with ``leaf`` (the caller may
    write the tensor in place as soon as ``save`` returns), and the dtype
    the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    """``save(step, state)`` / ``restore(like)`` over ``directory``,
    keeping the newest ``keep`` steps.

    ``copy_s`` and ``wait_s`` total the seconds ``save`` spent copying
    leaves to the host and the caller spent waiting on the writer thread;
    ``last_bytes`` is the size of the last saved state."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.copy_s = 0.0
        self.wait_s = 0.0
        self.last_bytes = 0
        os.makedirs(directory, exist_ok=True)
        self._gc_stale_tmp()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, block: bool = False) -> None:
        """Copy ``state`` to the host, then write it (on the writer thread
        when ``async_write`` and not ``block``).  The copy is complete when
        ``save`` returns.  Card tensors are copied after everything queued
        on their device, on every stream, has run."""
        flat = list(_flatten(state))
        t0 = time.perf_counter()
        for dev in {v.device for _, v in flat
                    if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        host = [(_key_str(p), *_host_copy(v)) for p, v in flat]
        self.copy_s += time.perf_counter() - t0
        self.last_bytes = sum(arr.nbytes for _, arr, _ in host)
        self.wait()
        if self.async_write and not block:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_async(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _gc_stale_tmp(self) -> None:
        """Remove ``step_*.tmp`` wreckage from a writer killed mid-save.
        A ``.tmp`` that was never renamed holds a partial array set; left
        in place it would seed a later same-step save with stale files."""
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _write(self, step: int, host: list) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            # a previous writer died mid-save at this very step: start clean
            # rather than inherit its partial (possibly stale-shaped) files
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for key, arr, dtype in host:
            fname = key.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "arrays": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def wait(self) -> None:
        """Join the writer thread; raise what it raised."""
        t = self._thread
        if t is not None:
            t0 = time.perf_counter()
            t.join()
            self.wait_s += time.perf_counter() - t0
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.isdir(os.path.join(self.directory, name))):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None,
                device: str | torch.device | None = None) -> Any:
        """Restore into the structure of ``like`` (its leaves only name
        the keys to read): every leaf comes back as a tensor of its saved
        dtype, on ``device`` — host memory when None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["arrays"]
        dev = resolve_device(device) if device is not None else None

        def load(path: tuple) -> torch.Tensor:
            info = manifest[_key_str(path)]
            t = _from_host(np.load(os.path.join(d, info["file"])),
                           info["dtype"])
            return t if dev is None else t.to(dev)

        return _rebuild(like, load)
