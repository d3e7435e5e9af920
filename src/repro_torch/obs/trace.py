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

Layer spans (:func:`span`, names in :data:`SPAN_NAMES`) time the port's
own layers from inside: each is one complete event with its ``id``, the
``parent`` span open around it on its thread and the ``batch`` (root
span) it belongs to.  They record only while a tracer is installed or a
``torch.profiler`` session records; otherwise a span is one flag check.
Live tracers stamp on :func:`profiler_clock`, the profiler's own clock,
so a program trace lies on a profiler trace of the same run.
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _tap
from torch.autograd.profiler import record_function
from torch.profiler.profiler import _KinetoProfile

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

#: the port's layer spans (:func:`span`): a closed set of their own,
#: apart from :data:`EVENT_KINDS`, which the runtimes share with ``repro``
SPAN_NAMES = frozenset({"cnn.forward", "im2col", "im2col.upload", "gemm",
                        "gemm.dispatch", "gemm.launch", "pool"})

#: kinds exported as paired "X" complete events (the rest are instants)
_SPAN_STARTS = {"panel_start"}
_SPAN_ENDS = {"panel_end"}

_seq = itertools.count()        # CPython-atomic global ordering tiebreak


def profiler_clock() -> float:
    """Seconds since the Unix epoch (``time.time_ns``): the clock
    ``torch.profiler`` stamps on, its chrome trace's ``ts`` (µs) plus
    ``baseTimeNanoseconds`` ÷ 1,000."""
    return time.time_ns() * 1e-9


class TraceEvent:
    """One recorded event: ``(ts, kind, track, dur, tags)``.

    ``ts`` is seconds on the tracer's clock (:func:`profiler_clock` for
    live runs, virtual seconds for sim runs); ``dur`` is only set on
    span-shaped events; ``tags`` is a small dict of identifying context
    (jobset, rid, tenant, priority, victim, ...).  ``stream`` is a layer
    span's pair of CUDA events, recorded on the stream at its start and
    end (:meth:`stream_ms`), where its input was on the card.
    """

    __slots__ = ("ts", "kind", "track", "dur", "tags", "seq", "stream")

    def __init__(self, ts, kind, track, dur=None, tags=None, seq=None,
                 stream=None):
        self.ts = ts
        self.kind = kind
        self.track = track
        self.dur = dur
        self.tags = tags or {}
        self.seq = next(_seq) if seq is None else seq
        self.stream = stream

    def stream_ms(self) -> float | None:
        """Milliseconds of the stream between the span's two CUDA events
        (idle inside the stretch included); None for a span without
        them.  Call it once the device has passed the second event."""
        if self.stream is None:
            return None
        start, end = self.stream
        return start.elapsed_time(end)

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

    def __init__(self, capacity: int = 65536, *, clock=profiler_clock,
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
        self.record(TraceEvent(self.clock() if ts is None else ts,
                               kind, track, dur, tags))

    def record(self, ev: TraceEvent) -> None:
        """Append a made event (as :meth:`emit` does)."""
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
    def export_chrome_trace(self, path: str, *,
                            beside: str | None = None) -> int:
        """Write Chrome ``trace_event`` JSON; returns #trace events.
        ``beside``: a ``torch.profiler`` chrome trace of the same run; the
        file then holds its events and these, moved onto its time base
        under a process id of their own, for one Perfetto view."""
        data = chrome_trace(self.events())
        if beside is not None:
            with open(beside) as f:
                data = _merge_chrome_traces(data, json.load(f))
        with open(path, "w") as f:
            json.dump(data, f)
        return len(data["traceEvents"])


# --------------------------------------------------------------- export

def chrome_trace(events: list[TraceEvent]) -> dict:
    """Convert events to a Chrome ``trace_event`` dict.

    ``panel_start``/``panel_end`` pairs on one track fold into ``"X"``
    complete events; layer spans are ``"X"`` events with their tags (and
    ``stream_ms`` once their CUDA events have passed) in ``args``; other
    kinds become ``"i"`` instants on their track; ``"M"`` metadata rows
    name each track.  Timestamps are microseconds from the earliest
    event, whose stamp ``otherData["baseTimeNanoseconds"]`` holds: on the
    profiler's clock, the Unix time that ``ts`` 0 stands for, as in a
    ``torch.profiler`` trace.
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
        if ev.kind in SPAN_NAMES:
            args = dict(ev.tags, kind=ev.kind)
            if ev.stream is not None and ev.stream[1].query():
                args["stream_ms"] = ev.stream_ms()
            out.append({"name": ev.kind, "cat": ev.kind, "ph": "X",
                        "ts": us, "dur": max(ev.dur or 0.0, 0.0) * 1e6,
                        "pid": 0, "tid": tid, "args": args})
            continue
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
            "otherData": {"source": "repro_torch.obs.trace",
                          "baseTimeNanoseconds": round(t0 * 1e9)}}


def _merge_chrome_traces(program: dict, profiler: dict) -> dict:
    """``profiler`` (a ``torch.profiler`` chrome trace) with the events of
    ``program`` (a :func:`chrome_trace` of events on the profiler's
    clock) moved onto its time base, under a process id of their own."""
    base = profiler.get("baseTimeNanoseconds", 0)
    shift = (program["otherData"]["baseTimeNanoseconds"] - base) / 1e3
    pid = 1 + max((e["pid"] for e in profiler["traceEvents"]
                   if isinstance(e.get("pid"), int)), default=0)
    moved = [dict(e, pid=pid, **({"ts": e["ts"] + shift} if "ts" in e
                                 else {}))
             for e in program["traceEvents"]]
    return dict(profiler, traceEvents=profiler["traceEvents"] + moved)


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
        if ph == "X" and d.get("cat") in SPAN_NAMES:
            out.append(TraceEvent(ts, d["cat"], track,
                                  d.get("dur", 0.0) / 1e6, tags))
        elif ph == "X":
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
    valid).  Checked: every kind is in :data:`EVENT_KINDS` or
    :data:`SPAN_NAMES`; every ``panel_start`` has a matching ``panel_end``
    on the SAME track (and vice versa); ``steal`` events name a real
    victim engine distinct from the thief's track; every layer span's
    ``parent`` is a span of the trace, on its track, open around it."""
    errs: list[str] = []
    open_panels: dict[str, int] = {}
    spans = {ev.tags.get("id"): ev for ev in events
             if ev.kind in SPAN_NAMES}
    for ev in events:
        if ev.kind in SPAN_NAMES:
            errs += _span_errors(ev, spans)
        elif ev.kind not in EVENT_KINDS:
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


#: stamps of a parent and its child may round apart by this much (s)
_NEST_SLACK_S = 1e-6


def _span_errors(ev: TraceEvent, spans: dict) -> list[str]:
    pid = ev.tags.get("parent")
    if pid is None:
        return []
    what = f"span {ev.kind!r} #{ev.tags.get('id')}"
    parent = spans.get(pid)
    if parent is None:
        return [f"{what}: its parent #{pid} is not in the trace"]
    if parent.track != ev.track or not (
            parent.ts - _NEST_SLACK_S <= ev.ts
            and ev.ts + ev.dur <= parent.ts + parent.dur + _NEST_SLACK_S):
        return [f"{what} is not inside its parent #{pid} "
                f"({parent.kind!r} on {parent.track!r})"]
    return []


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


# ---------------------------------------------------------- layer spans
#: where spans go while a profiler session records and no tracer is
#: installed: the benchmark's readers take them from here
#: (:func:`profiled_forwards`)
_profiled = Tracer(capacity=1 << 16)
_span_ids = itertools.count(1)
_open = threading.local()        # .stack: the spans open on a thread


def profiled_tracer() -> Tracer:
    """The process-global recorder that spans write to while a
    ``torch.profiler`` session records and no tracer is installed.  It
    is never cleared on its own: its owner calls ``clear()``."""
    return _profiled


class _Off:
    """The span while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags) -> None:
        pass

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, /, *, device: torch.device | None = None, **tags):
    """``with span(name, **tags) as s:`` times one layer of the port.

    While no tracer is installed and no ``torch.profiler`` session
    records, this is one flag check and records nothing.  Otherwise the
    span writes one complete :class:`TraceEvent` at its end (``kind`` the
    name, ``ts`` its start, ``dur``) to the installed tracer, or else to
    :func:`profiled_tracer`, with ``id``, ``parent`` (the span open
    around it on this thread) and ``batch`` (the outermost one's id)
    among its tags.  ``device``: where the span's work runs; on the card
    a CUDA event is recorded on the current stream at the start and the
    end (:meth:`TraceEvent.stream_ms`), resolved by whoever reads them.
    While the profiler records the host's operations the span is also a
    ``record_function`` of its name, so the profiler's trace shows it;
    in a session of device activity alone it is not, since such a call
    costs the host ~10 µs even where nothing records it.

    ``s.tag(**tags)`` adds tags; ``s.count(**counts)`` adds counts to
    the span's tags and to its batch's."""
    if _default is None and not _tap._is_profiler_enabled:
        return _OFF
    if name not in SPAN_NAMES:
        raise ValueError(f"{name!r} is not one of SPAN_NAMES")
    return _Span(name, device, tags)


class _Span:
    __slots__ = ("name", "device", "tags", "tracer", "root", "mirror",
                 "t0", "_start", "_rf")

    def __init__(self, name, device, tags):
        self.name, self.device, self.tags = name, device, tags
        self._start = self._rf = None

    def tag(self, **tags) -> None:
        self.tags.update(tags)

    def count(self, **counts) -> None:
        for key, n in counts.items():
            self.tags[key] = self.tags.get(key, 0) + n
            if self.root is not self:
                self.root.tags[key] = self.root.tags.get(key, 0) + n

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
            _open.track = threading.current_thread().name
        tags = self.tags
        tags["id"] = sid = next(_span_ids)
        if stack:
            parent = stack[-1]
            self.root, self.mirror = parent.root, parent.mirror
            tags["parent"], tags["batch"] = parent.tags["id"], \
                self.root.tags["id"]
        else:
            self.root = self
            self.mirror = _tap._is_profiler_enabled and _records_host_ops()
            tags["parent"], tags["batch"] = None, sid
        self.tracer = _default if _default is not None else _profiled
        stack.append(self)
        if self.mirror:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        # stamped inside the mirror and around the span's own events, so
        # the two stamps agree and the host's time holds what tracing adds
        self.t0 = self.tracer.clock()
        if self.device is not None and self.device.type == "cuda":
            self._start = _stream_event(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        stream = None
        if self._start is not None:
            stream = (self._start, _stream_event(self.device))
        t1 = self.tracer.clock()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        _open.stack.pop()
        if exc_type is not None:
            self.tags["err"] = exc_type.__name__
        self.tracer.record(TraceEvent(self.t0, self.name, _open.track,
                                      t1 - self.t0, self.tags,
                                      stream=stream))
        return False


_streams: dict[tuple, torch.cuda.Stream] = {}


def _stream_event(device: torch.device):
    """A timing CUDA event recorded now on ``device``'s current stream.
    It is ``torch.cuda.Event``'s base class and its stream is looked up
    raw and kept: the Python wrappers cost more than the event."""
    index = (device.index if device.index is not None
             else torch._C._cuda_getDevice())
    key = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    event = torch._C._CudaEventBase(enable_timing=True)
    event.record(stream)
    return event


def _records_host_ops() -> bool:
    """Whether the ``torch.profiler`` session now recording records the
    host's operations (CPU activity).  torch keeps no handle on the
    running session, so this reads the session's own object among the
    locals of the calling frames (``with profile(...) as p:`` and
    ``p.start()`` keep it in one), ~5 µs; True where none is found, since
    a session records the host by default."""
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            if isinstance(v, _KinetoProfile):
                v = v.profiler
            if (isinstance(v, _tap.profile) and v.entered
                    and v.kineto_results is None):
                return v.use_cpu
        frame = frame.f_back
    return True


def profiled_forwards(n: int
                      ) -> list[tuple[TraceEvent, list[TraceEvent]]] | None:
    """The first ``n`` ``cnn.forward`` spans of :func:`profiled_tracer`
    (by start), each with the other spans of its batch; None where the
    recorder holds fewer or has dropped any."""
    events = _profiled.events()
    forwards = [e for e in events if e.kind == "cnn.forward"][:n]
    if _profiled.dropped or n <= 0 or len(forwards) < n:
        return None
    batches = {f.tags["id"]: (f, []) for f in forwards}
    for e in events:
        b = batches.get(e.tags.get("batch"))
        if b is not None and e is not b[0]:
            b[1].append(e)
    return list(batches.values())
