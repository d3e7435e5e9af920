"""The profiler's windows and what the per-layer metrics read from them.

Three windows follow the measured one in a ``--trace 1`` run, each of the
cell's own batches through the same loop:

- the *device* window (``torch.profiler`` with CUDA activity only, so
  that the host runs as it does untraced): the device's busy time (the
  union of its kernel, copy and set intervals, as
  ``chip_smoke.py::union_us`` took it) and the device operations that took
  most time.  Its length is the loop's own, on the host clock, from the
  first submission until the last answers reached the host: every device
  operation of the window lies inside it;
- the *gaps* window (CPU and CUDA activities): the longest idle gaps of
  the device, named by what the host was doing in them.  Recording the
  host's operations slows the host, so this window names gaps and gives
  no busy or idle share;
- the *layer* window (the same with ``with_stack=True``), whose Python
  frames attribute each device operation to the port's function that
  launched it: a kernel's correlation id ties it to its launch call, and
  the frames of the port open on the launching thread at that instant are
  its stack.  Kernel names are never read, so a kernel that a later change
  replaces still counts to its layer.  This window gives device times
  only.

Each trace is exported to a temporary directory, read and deleted.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Callable

__all__ = ["DEVICE_CATS", "profile_events", "union_us", "device_time",
           "idle_gaps", "attribute", "port_frame"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_PY_NAME = re.compile(r"^(?P<file>.*)\((?P<line>\d+)\): (?P<func>.*)$")
_PORT = "repro_torch/"
WINDOW_SPAN = "bench.window"


def profile_events(run: Callable[[], None], *, host: bool,
                   with_stack: bool = False) -> tuple[list, int]:
    """``run()`` under ``torch.profiler`` (CUDA activity, and the host's
    operations where ``host``): its chrome trace's events and the trace's
    size in bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities,
                     with_stack=with_stack) as prof:
            run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, size


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _window(events: list) -> tuple[float, float]:
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"trace: {len(spans)} '{WINDOW_SPAN}' spans, "
                           f"expected one")
    return spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]


def _clipped(events: list, lo: float, hi: float) -> list:
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, t = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi)
            if t > s:
                out.append((s, t, e))
    return out


def device_time(events: list, top: int = 10) -> dict:
    """From the device window: ``busy_s`` (the union of every device
    interval of the trace) and ``device_ops`` (the ``top`` device
    operations by total seconds)."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    by_name: dict[str, float] = collections.Counter()
    for s, t, e in dev:
        by_name[e["name"][:160]] += (t - s) / 1e6
    return {"busy_s": union_us((s, t) for s, t, _ in dev) / 1e6,
            "device_ops": [[n, s] for n, s in by_name.most_common(top)]}


def idle_gaps(events: list, top: int = 10) -> list:
    """From the gaps window: the device's idle seconds inside the window
    span, by what the host was doing (the innermost host event open at
    each gap's middle), the ``top`` names."""
    lo, hi = _window(events)
    gaps, cursor = [], lo
    for s, t, _ in sorted(_clipped(events, lo, hi), key=lambda x: x[0]):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if hi > cursor:
        gaps.append((cursor, hi))
    idle: dict[str, float] = collections.Counter()
    for (g0, g1), name in zip(gaps, _host_at(events, [(a + b) / 2
                                                      for a, b in gaps])):
        idle[name[:160]] += (g1 - g0) / 1e6
    return [[n, s] for n, s in idle.most_common(top)]


def _host_at(events: list, instants: list) -> list[str]:
    """What the thread that ran the window span was doing at each of the
    sorted ``instants``: the innermost host event (an op, a runtime call,
    a span of the harness) open then, by one sweep over the nested
    events of that thread."""
    tid = next(e.get("tid") for e in events
               if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN)
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events if e.get("cat") in _HOST_CATS
                   and e.get("ph") == "X" and e.get("tid") == tid
                   and e.get("name") != WINDOW_SPAN),
                  key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in instants:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: no op recorded")
    return out


def port_frame(name: str) -> str | None:
    """``"models/ssm.py:mamba2_block"`` for a Python frame of the port
    (``.../repro_torch/models/ssm.py(150): mamba2_block``), else None."""
    m = _PY_NAME.match(name)
    if m is None:
        return None
    path = m["file"].replace("\\", "/")
    at = path.rfind(_PORT)
    if at < 0:
        return None
    return f"{path[at + len(_PORT):]}:{m['func']}"


def attribute(events: list) -> dict:
    """From the layer window: device seconds by the stack of the port's
    frames (outermost first) that launched each device operation, inside
    the window span.  ``None`` keys the operations whose launch the trace
    does not hold; ``()`` those launched outside any frame of the port."""
    lo, hi = _window(events)
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), e["ts"])
    frames: dict = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function":
            frame = port_frame(e["name"])
            if frame is not None:
                frames[e.get("tid")].append(
                    (e["ts"], e["ts"] + e.get("dur", 0), frame))
    queries: dict = collections.defaultdict(list)
    out: dict = collections.Counter()
    for s, t, e in _clipped(events, lo, hi):
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launches:
            out[None] += (t - s) / 1e6
            continue
        tid, ts = launches[corr]
        queries[tid].append((ts, (t - s) / 1e6))
    for tid, qs in queries.items():
        stack: list = []
        fs = sorted(frames.get(tid, []), key=lambda f: (f[0], -f[1]))
        i = 0
        for ts, secs in sorted(qs):
            while i < len(fs) and fs[i][0] <= ts:
                while stack and stack[-1][1] <= fs[i][0]:
                    stack.pop()
                stack.append(fs[i])
                i += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            out[tuple(f[2] for f in stack)] += secs
    return dict(out)
