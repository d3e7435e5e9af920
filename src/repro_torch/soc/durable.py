"""repro_torch.soc.durable — process-level durability for the serving engine.

The runtime's fault recovery (:mod:`repro_torch.soc.faults`) makes the
*pool* survive a misbehaving accelerator; this module makes the
*process* survive.  An embedded deployment like Synergy's runs for
weeks — a crash must not lose admitted requests, the online-calibrated
int8 activation scales, the learned engine rates, or the QoS health
baselines, and a restart must not serve anything twice.  Three pieces:

* **Write-ahead request journal** (:class:`RequestJournal`): every
  admission-accepted request and every emitted token is appended —
  length-prefixed, CRC'd, fsync'd — BEFORE it becomes externally
  visible.  A record half-written by a dying process is a *torn tail*:
  detected by the CRC/length scan, truncated on reopen, and by
  construction it only ever covers state that was never externally
  visible, so dropping it is correct.
* **Crash-consistent snapshots**: the server persists its full state
  through :class:`~repro_torch.checkpoint.Checkpointer` (atomic
  ``step_N.tmp`` rename, async double-buffered) on a step cadence —
  K/V + SSM caches, slot positions, pending queues, the chunked-prefill
  cursor, calibrator EMA state, runtime sidecar rates, health baselines,
  FairShare virtual times, and the journal offset the snapshot covers.
* **Deterministic restore**: ``SynergyServer.restore`` loads the latest
  snapshot and *re-executes* the journal suffix — admissions are forced
  from the journaled waves (scheduling is wall-clock dependent; token
  values are not), recomputed emissions are verified bitwise against the
  journal (a mismatch flight-dumps and raises :class:`RestoreMismatch`),
  and replayed work books into ``ServeStats.replayed_tokens`` /
  ``replayed_jobs`` instead of re-inflating throughput counters.

:class:`CrashPlan` is the process-level complement of the
engine-level ``FaultPlan``: a deterministic crash point (engine step)
at which the server raises :class:`SimulatedCrash`, so the keystone
property — *token streams after restore are bitwise identical to the
uninterrupted run, every accepted request served exactly once* — is
testable over arbitrary crash points without actually killing pytest.

SIGTERM wiring: servers constructed with a :class:`Durability` register
themselves here; :func:`install_sigterm_handler` (for a process
that runs durable servers) turns SIGTERM into a graceful
``request_drain()`` — finish live generations, snapshot, release the
pool — instead of a dead pool and a torn journal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import struct
import threading
import weakref
import zlib
from typing import Optional

import numpy as np

__all__ = ["Durability", "RequestJournal", "CrashPlan", "SimulatedCrash",
           "RestoreMismatch", "load_snapshot", "meta_to_array",
           "array_to_meta", "install_sigterm_handler",
           "install_sigterm_drain", "register_server",
           "request_drain_all"]

#: journal record header: payload length + CRC32 of the payload
_HDR = struct.Struct("<II")


class SimulatedCrash(BaseException):
    """The deterministic crash point of a :class:`CrashPlan` fired.

    Deliberately NOT a ``RuntimeError``: nothing in the serving loop may
    catch-and-continue it — the harness that installed the plan treats
    the server object as dead and restores a fresh one from disk, which
    is the whole point."""


class RestoreMismatch(RuntimeError):
    """Replay re-executed a journaled step and produced different bytes.

    The journal is the record of what was externally delivered; a
    recomputation that disagrees means the restored state is NOT the
    crashed process's state (corrupted snapshot, different params, a
    nondeterministic model).  Serving must not continue from it."""

    def __init__(self, expected, got):
        self.expected = expected
        self.got = got
        super().__init__(
            f"journal replay diverged: expected {expected!r}, "
            f"recomputed {got!r}")


@dataclasses.dataclass(frozen=True)
class Durability:
    """Durable-serving configuration (``SynergyServer(durable=...)``).

    ``directory`` holds ``journal.bin`` plus ``snapshots/step_N/``.
    ``snapshot_every=N`` snapshots at every N-th engine step (0 = only
    on ``close()``); ``fsync=False`` trades crash safety of the last few
    records for journal append latency; ``async_snapshots`` writes
    snapshots on the Checkpointer's background thread, double-buffered
    against serving."""

    directory: str
    snapshot_every: int = 0
    fsync: bool = True
    keep: int = 3
    async_snapshots: bool = True

    @property
    def journal_path(self) -> str:
        return os.path.join(self.directory, "journal.bin")

    @property
    def snapshot_dir(self) -> str:
        return os.path.join(self.directory, "snapshots")


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Deterministic process-crash point: raise :class:`SimulatedCrash`
    at the START of engine step ``at_step`` (0-based — before the step
    does any work or journals anything, the same boundary a SIGKILL
    between steps lands on).  The engine-level analog is
    :class:`~repro_torch.soc.faults.FaultPlan`."""

    at_step: int

    def due(self, engine_steps: int) -> bool:
        return engine_steps >= self.at_step


class RequestJournal:
    """Append-only write-ahead log of serving's externally visible events.

    Record framing: ``<u32 length><u32 crc32><payload>`` with a compact
    JSON payload.  Appends are flushed (and fsync'd unless disabled)
    before the caller makes the event visible, so the journal is always
    at least as new as the world.  Opening an existing journal scans it
    and TRUNCATES a torn tail (``truncated_bytes`` reports how much) —
    a half-written record must never corrupt records appended after
    restart."""

    def __init__(self, path, *, fsync: bool = True):
        self.path = os.fspath(path)
        self.fsync = fsync
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        _, end, torn = self.scan(self.path)
        self.truncated_bytes = 0
        if torn:
            self.truncated_bytes = os.path.getsize(self.path) - end
            with open(self.path, "rb+") as f:
                f.truncate(end)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()

    def append(self, rec: dict) -> int:
        """Durably append one record; returns the offset AFTER it (the
        value a snapshot stores as the journal position it covers)."""
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        with self._lock:
            self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
            self._f.write(payload)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            return self._f.tell()

    def offset(self) -> int:
        with self._lock:
            self._f.flush()
            return self._f.tell()

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()

    @staticmethod
    def scan(path, start: int = 0) -> tuple[list, int, bool]:
        """Read records from byte ``start`` (a record boundary).

        Returns ``(records, end_offset, torn)`` — ``end_offset`` is the
        last valid record boundary; ``torn`` is True when trailing bytes
        past it fail the length/CRC check (crash mid-append)."""
        records: list[dict] = []
        path = os.fspath(path)
        if not os.path.exists(path):
            return records, start, False
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(start)
            off = start
            while off + _HDR.size <= size:
                ln, crc = _HDR.unpack(f.read(_HDR.size))
                if off + _HDR.size + ln > size:
                    return records, off, True
                payload = f.read(ln)
                if zlib.crc32(payload) != crc:
                    return records, off, True
                try:
                    records.append(json.loads(payload.decode("utf-8")))
                except ValueError:
                    return records, off, True
                off += _HDR.size + ln
            return records, off, off < size


# ---------------------------------------------------------------------------
# Snapshot meta encoding — JSON as a uint8 leaf, so the WHOLE snapshot
# (arrays + metadata) travels through the Checkpointer unchanged
# ---------------------------------------------------------------------------

def meta_to_array(meta: dict) -> np.ndarray:
    """Encode a JSON-safe dict as a uint8 array — one more Checkpointer
    leaf, covered by the same atomic-rename publish as the cache arrays
    (no second metadata file with its own torn-write failure mode)."""
    return np.frombuffer(
        json.dumps(meta, separators=(",", ":")).encode("utf-8"),
        dtype=np.uint8).copy()


def array_to_meta(arr) -> dict:
    return json.loads(np.asarray(arr).tobytes().decode("utf-8"))


def load_snapshot(ck, step: Optional[int] = None) -> tuple[int, dict]:
    """Load one Checkpointer snapshot as ``(step, {key: array})``.

    Server snapshots are FLAT string-keyed dicts, so the restore ``like``
    tree is reconstructed from the manifest's keys alone — no caller
    needs to know the snapshot's dynamic shape (whether a chunked-prefill
    cursor was in flight, how many cache leaves the family has) before
    reading it."""
    step = step if step is not None else ck.latest_step()
    if step is None:
        raise FileNotFoundError(f"no snapshots in {ck.directory}")
    d = os.path.join(ck.directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        keys = list(json.load(f)["arrays"])
    return step, ck.restore({k: 0 for k in keys}, step=step)


# ---------------------------------------------------------------------------
# SIGTERM → graceful drain
# ---------------------------------------------------------------------------

#: live durable servers (weak: a collected server needs no deregistration)
_SERVERS: "weakref.WeakSet" = weakref.WeakSet()


def register_server(server) -> None:
    """Called by ``SynergyServer`` when constructed with a Durability."""
    _SERVERS.add(server)


def request_drain_all() -> int:
    """Flag every registered durable server to drain (async-signal-safe:
    sets flags only; the serving loops notice at their next step)."""
    n = 0
    for srv in list(_SERVERS):
        srv.request_drain()
        n += 1
    return n


def install_sigterm_handler(signum: int = signal.SIGTERM) -> bool:
    """Turn SIGTERM into a graceful drain of every durable server in the
    process (a long run then dies with a clean snapshot instead of a
    dead pool).  Returns False
    when handlers cannot be installed (non-main thread)."""
    def _handler(sig, frame):
        request_drain_all()
    try:
        signal.signal(signum, _handler)
    except ValueError:
        return False
    return True


def install_sigterm_drain(server, signum: int = signal.SIGTERM) -> None:
    """Single-server variant for examples: SIGTERM flags ``server`` to
    drain at its next step; ``run()`` then closes it (drain → snapshot →
    release pool)."""
    def _handler(sig, frame):
        server.request_drain()
    signal.signal(signum, _handler)
