"""Span tracer: a lock-cheap, ring-buffered event recorder.

Every execution layer (work-stealing runtime, graph scheduler, serving
loop, virtual-time sim) emits the SAME small vocabulary of typed events
(:data:`EVENT_KINDS`) onto named *tracks* — one track per engine worker
plus ``manager`` / ``serving`` / ``admission`` / ``graph`` tracks — so a
live trace and a virtual-time simulator trace are directly diffable.

Hot-path design: ``emit()`` appends to a *thread-local* list (no lock);
cells are flushed into the shared bounded ring under one lock every
``flush_every`` events and on ``events()`` / export.  A disabled tracer
is simply ``None`` at the instrumentation site — the guard is one
attribute load, so tracing off costs nothing and cannot perturb
scheduling.

Export is Chrome/Perfetto ``trace_event`` JSON: ``panel_start`` /
``panel_end`` pairs become ``"X"`` complete events with durations, every
other kind becomes an ``"i"`` instant, and ``"M"`` metadata events name
the per-track rows so the file loads directly in ``chrome://tracing`` or
https://ui.perfetto.dev.
"""

from __future__ import annotations

import itertools
import json
import threading
from contextlib import contextmanager
from time import perf_counter

#: the closed event vocabulary shared by live runtime, graph scheduler,
#: serving loop, and the virtual-time sim twin
EVENT_KINDS = frozenset({
    "panel_start", "panel_end",          # one engine executing one panel
    "steal", "seed", "enqueue", "dequeue",
    "graph_node_ready", "graph_node_done", "graph_node_cancelled",
    "graph_node_retry",
    "admission", "shed",
    "quarantine", "readmit",
    "deadline_hit", "deadline_miss",
    "dispatch",
    "fault_injected", "panel_retry",     # fault-injection + recovery layer
    "worker_death", "orphan_reseed",
    "journal", "snapshot", "restore",    # durable-serving layer
    "drain",
})

#: kinds exported as paired "X" complete events (the rest are instants)
_SPAN_STARTS = {"panel_start"}
_SPAN_ENDS = {"panel_end"}

_seq = itertools.count()        # CPython-atomic global ordering tiebreak


class TraceEvent:
    """One recorded event: ``(ts, kind, track, dur, tags)``.

    ``ts`` is seconds on the tracer's clock (``time.perf_counter`` for
    live runs, virtual seconds for sim runs); ``dur`` is only set on
    span-shaped events; ``tags`` is a small dict of identifying context
    (jobset, rid, tenant, priority, victim, ...).
    """

    __slots__ = ("ts", "kind", "track", "dur", "tags", "seq")

    def __init__(self, ts, kind, track, dur=None, tags=None, seq=None):
        self.ts = ts
        self.kind = kind
        self.track = track
        self.dur = dur
        self.tags = tags or {}
        self.seq = next(_seq) if seq is None else seq

    def to_dict(self) -> dict:
        d = {"ts": self.ts, "kind": self.kind, "track": self.track}
        if self.dur is not None:
            d["dur"] = self.dur
        if self.tags:
            d["tags"] = self.tags
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(d["ts"], d["kind"], d["track"], d.get("dur"),
                   dict(d.get("tags", {})))

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TraceEvent({self.ts:.6f}, {self.kind!r}, {self.track!r},"
                f" dur={self.dur}, tags={self.tags})")


class Tracer:
    """Bounded in-memory event recorder with thread-local write buffers.

    >>> tr = Tracer(capacity=4096)
    >>> tr.emit("steal", "F-PE", victim="S-PE", jobset="step0")
    >>> tr.export_chrome_trace("results/run.json")
    """

    def __init__(self, capacity: int = 65536, *, clock=perf_counter,
                 flush_every: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock = clock
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        self._ring: list[TraceEvent] = []       # bounded under _lock
        self._dropped = 0
        self._tls = threading.local()
        self._cells: list[list[TraceEvent]] = []    # every live TLS cell

    # ------------------------------------------------------------ write
    def now(self) -> float:
        return self.clock()

    def emit(self, kind: str, track: str, *, ts: float | None = None,
             dur: float | None = None, **tags) -> None:
        """Record one event.  Lock-free except every ``flush_every``-th
        call on each thread (and first call, which registers the cell)."""
        ev = TraceEvent(self.clock() if ts is None else ts,
                        kind, track, dur, tags)
        cell = getattr(self._tls, "cell", None)
        if cell is None:
            cell = self._tls.cell = []
            with self._lock:
                self._cells.append(cell)
        cell.append(ev)
        if len(cell) >= self.flush_every:
            with self._lock:
                self._absorb_locked(cell)

    def span(self, base: str, track: str, ts: float, dur: float,
             **tags) -> None:
        """Emit a ``{base}_start`` / ``{base}_end`` pair with explicit
        stamps (both carry the same tags; the start carries ``dur``)."""
        self.emit(f"{base}_start", track, ts=ts, dur=dur, **tags)
        self.emit(f"{base}_end", track, ts=ts + dur, **tags)

    def _absorb_locked(self, cell: list) -> None:
        self._ring.extend(cell)
        del cell[:]
        excess = len(self._ring) - self.capacity
        if excess > 0:                      # ring semantics: keep newest
            del self._ring[:excess]
            self._dropped += excess

    # ------------------------------------------------------------- read
    def events(self) -> list[TraceEvent]:
        """Flush all thread-local cells and return the ring, oldest
        first, ordered by (ts, seq) so multi-thread output is stable."""
        with self._lock:
            for cell in self._cells:
                if cell:
                    self._absorb_locked(cell)
            out = list(self._ring)
        out.sort(key=lambda e: (e.ts, e.seq))
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring) + sum(len(c) for c in self._cells)

    def clear(self) -> None:
        with self._lock:
            for cell in self._cells:
                del cell[:]
            self._ring.clear()
            self._dropped = 0

    def counts(self) -> dict[str, int]:
        """{kind: n} histogram of recorded events (flushes first)."""
        out: dict[str, int] = {}
        for ev in self.events():
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    # ----------------------------------------------------------- export
    def export_chrome_trace(self, path: str) -> int:
        """Write Chrome ``trace_event`` JSON; returns #trace events."""
        data = chrome_trace(self.events())
        with open(path, "w") as f:
            json.dump(data, f)
        return len(data["traceEvents"])


# --------------------------------------------------------------- export

def chrome_trace(events: list[TraceEvent]) -> dict:
    """Convert events to a Chrome ``trace_event`` dict.

    ``panel_start``/``panel_end`` pairs on one track fold into ``"X"``
    complete events; other kinds become ``"i"`` instants on their track;
    ``"M"`` metadata rows name each track.  Timestamps are microseconds
    from the earliest event (Chrome's epoch is arbitrary).
    """
    tids: dict[str, int] = {}
    out: list[dict] = []
    t0 = min((e.ts for e in events), default=0.0)

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
        return tid

    open_spans: dict[tuple, list[TraceEvent]] = {}
    for ev in events:
        us = (ev.ts - t0) * 1e6
        tid = tid_of(ev.track)
        if ev.kind in _SPAN_STARTS:
            open_spans.setdefault((ev.track, ev.kind), []).append(ev)
            continue
        if ev.kind in _SPAN_ENDS:
            base = ev.kind[:-len("_end")]
            stack = open_spans.get((ev.track, base + "_start"))
            if stack:
                start = stack.pop()
                name = start.tags.get("jobset") or base
                out.append({
                    "name": str(name), "cat": base, "ph": "X",
                    "ts": (start.ts - t0) * 1e6,
                    "dur": max(ev.ts - start.ts, 0.0) * 1e6,
                    "pid": 0, "tid": tid,
                    "args": dict(start.tags, kind=base),
                })
            else:                               # eviction split the pair
                out.append({"name": base, "cat": base, "ph": "E",
                            "ts": us, "pid": 0, "tid": tid,
                            "args": dict(ev.tags, kind=ev.kind)})
            continue
        out.append({
            "name": ev.kind, "cat": ev.kind, "ph": "i", "s": "t",
            "ts": us, "pid": 0, "tid": tid,
            "args": dict(ev.tags, kind=ev.kind),
        })
    # unmatched starts (still running / end evicted) -> "B" begin events
    for (track, _kind), stack in open_spans.items():
        for start in stack:
            out.append({
                "name": str(start.tags.get("jobset") or "panel"),
                "cat": "panel", "ph": "B",
                "ts": (start.ts - t0) * 1e6, "pid": 0,
                "tid": tid_of(track),
                "args": dict(start.tags, kind=start.kind),
            })
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "repro-synergy"}}]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": tid, "args": {"name": track}})
    out.sort(key=lambda d: d["ts"])
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs.trace"}}


def load_chrome_trace(path: str) -> list[TraceEvent]:
    """Parse an exported Chrome trace back into :class:`TraceEvent`s.

    ``"X"`` complete events unfold into a ``panel_start``/``panel_end``
    pair; instants map back to their recorded kind.  Timestamps come
    back in seconds relative to the export epoch — fine for replay
    invariants, not for diffing against the original absolute stamps.
    """
    with open(path) as f:
        data = json.load(f)
    names: dict[int, str] = {}
    for d in data["traceEvents"]:
        if d.get("ph") == "M" and d.get("name") == "thread_name":
            names[d["tid"]] = d["args"]["name"]
    out: list[TraceEvent] = []
    for d in data["traceEvents"]:
        ph = d.get("ph")
        if ph == "M":
            continue
        track = names.get(d.get("tid"), str(d.get("tid")))
        ts = d["ts"] / 1e6
        tags = {k: v for k, v in d.get("args", {}).items() if k != "kind"}
        if ph == "X":
            dur = d.get("dur", 0.0) / 1e6
            base = d.get("cat", "panel")
            out.append(TraceEvent(ts, base + "_start", track, dur, tags))
            out.append(TraceEvent(ts + dur, base + "_end", track, None,
                                  dict(tags)))
        elif ph in ("i", "I"):
            kind = d.get("args", {}).get("kind", d.get("name"))
            out.append(TraceEvent(ts, kind, track, None, tags))
        elif ph == "B":
            out.append(TraceEvent(ts, d["args"].get("kind", "panel_start"),
                                  track, None, tags))
        elif ph == "E":
            out.append(TraceEvent(ts, d["args"].get("kind", "panel_end"),
                                  track, None, tags))
    out.sort(key=lambda e: (e.ts, e.seq))
    return out


def validate_events(events: list[TraceEvent], *,
                    engines: set[str] | None = None) -> list[str]:
    """Replay-invariant checks; returns a list of violations (empty =
    valid).  Checked: every kind is in :data:`EVENT_KINDS`; every
    ``panel_start`` has a matching ``panel_end`` on the SAME track (and
    vice versa); ``steal`` events name a real victim engine distinct
    from the thief's track."""
    errs: list[str] = []
    open_panels: dict[str, int] = {}
    for ev in events:
        if ev.kind not in EVENT_KINDS:
            errs.append(f"unknown event kind {ev.kind!r} on {ev.track!r}")
        if ev.kind == "panel_start":
            open_panels[ev.track] = open_panels.get(ev.track, 0) + 1
        elif ev.kind == "panel_end":
            n = open_panels.get(ev.track, 0)
            if n <= 0:
                errs.append(f"panel_end without panel_start on "
                            f"track {ev.track!r} at ts={ev.ts:.6f}")
            else:
                open_panels[ev.track] = n - 1
        elif ev.kind == "steal":
            victim = ev.tags.get("victim")
            if not victim:
                errs.append(f"steal without victim tag at ts={ev.ts:.6f}")
            elif victim == ev.track:
                errs.append(f"steal from self on track {ev.track!r}")
            elif engines is not None and victim not in engines:
                errs.append(f"steal victim {victim!r} is not a known "
                            f"engine (have {sorted(engines)})")
            if engines is not None and ev.track not in engines:
                errs.append(f"steal on non-engine track {ev.track!r}")
    for track, n in open_panels.items():
        if n:
            errs.append(f"{n} unmatched panel_start on track {track!r}")
    return errs


# ------------------------------------------------------- default tracer
#: process-global default: `SynergyRuntime` falls back to this when no
#: tracer is passed, so `benchmarks/run.py --trace` can capture runtimes
#: constructed deep inside benchmark bodies.  ``None`` = tracing off.
_default: Tracer | None = None


def set_default_tracer(tracer: Tracer | None) -> None:
    global _default
    _default = tracer


def get_default_tracer() -> Tracer | None:
    return _default


@contextmanager
def trace_scope(tracer: Tracer):
    """Install ``tracer`` as the process default for the ``with`` body."""
    prev = _default
    set_default_tracer(tracer)
    try:
        yield tracer
    finally:
        set_default_tracer(prev)
