"""Metrics: counters / gauges / fixed-bucket histograms + Prometheus text.

Design rule: the runtime and server do NOT maintain parallel
counters for the registry.  ``Telemetry`` / ``ServeStats`` /
``TenantStats`` / ``rt.stats()`` stay the single source of truth and the
registry is populated from those *views* at collect time
(:func:`collect_runtime` / :func:`collect_server` /
:func:`collect_calibrator`, all invoked by :func:`render_prometheus`).
The only per-observation instrument is the per-tenant queue-wait
histogram, which the server feeds behind a single attribute check — its
``observe()`` is allocation-free (fixed bucket list, bisect index).

>>> from repro_torch.obs.metrics import render_prometheus
>>> print(render_prometheus(runtime=rt, server=srv))
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds) — tuned for queue waits that span
#: sub-millisecond sim stamps up to multi-second overload backlogs
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names, values) -> str:
    if not names:
        return ""
    pairs = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in zip(names, values))
    return "{" + pairs + "}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Child:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Child):
    """Monotonic count.  ``set_total`` exists for view-fed collection
    (the authoritative count lives in Telemetry/ServeStats)."""

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += v

    def set_total(self, v: float) -> None:
        with self._lock:
            self._value = max(self._value, float(v))


class Gauge(_Child):
    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._value -= v


class Histogram:
    """Fixed-bucket cumulative histogram.  ``observe`` touches a
    preallocated count list via one bisect — no allocation, one lock."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("need at least one bucket bound")
        self.buckets = tuple(b)
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)       # +1 for the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _Family:
    """One named metric family; holds labeled children."""

    def __init__(self, name: str, help: str, kind: str, labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self._buckets)

    def labels(self, *values, **kv):
        if kv:
            values = tuple(kv[ln] for ln in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._make_child())
        return child

    def _default_child(self):
        return self.labels()

    # unlabeled convenience passthroughs
    def inc(self, v: float = 1.0):
        self._default_child().inc(v)

    def set(self, v: float):
        self._default_child().set(v)

    def set_total(self, v: float):
        self._default_child().set_total(v)

    def observe(self, v: float):
        self._default_child().observe(v)

    @property
    def value(self) -> float:
        return self._default_child().value

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help or self.name}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            if self.kind == "histogram":
                counts, total, n = child.snapshot()
                cum = 0
                for bound, c in zip(child.buckets + (math.inf,), counts):
                    cum += c
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(self.labelnames + ('le',), values + (_fmt(bound),))}"
                        f" {cum}")
                lines.append(f"{self.name}_sum"
                             f"{_fmt_labels(self.labelnames, values)}"
                             f" {_fmt(total)}")
                lines.append(f"{self.name}_count"
                             f"{_fmt_labels(self.labelnames, values)}"
                             f" {n}")
            else:
                lines.append(f"{self.name}"
                             f"{_fmt_labels(self.labelnames, values)}"
                             f" {_fmt(child.value)}")
        return lines


class MetricsRegistry:
    """Named families, rendered in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get(self, name, help, kind, labelnames, buckets=DEFAULT_BUCKETS):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, kind, labelnames, buckets)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered with different "
                    f"type/labels ({fam.kind}{fam.labelnames} vs "
                    f"{kind}{tuple(labelnames)})")
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._get(name, help, "counter", labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get(name, help, "gauge", labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get(name, help, "histogram", labelnames, buckets)

    def render(self) -> str:
        with self._lock:
            fams = list(self._families.values())
        lines: list[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n" if lines else ""

    def clear(self) -> None:
        with self._lock:
            self._families.clear()


#: process-global registry used by `render_prometheus()` by default
REGISTRY = MetricsRegistry()


# ----------------------------------------------------------- collectors

def collect_runtime(rt, registry: MetricsRegistry = REGISTRY) -> None:
    """Feed the registry from ``rt.stats()`` + per-engine Telemetry
    (views only — nothing here is bookkept twice)."""
    st = rt.stats()
    eng = registry.gauge("repro_engine_queue_depth",
                         "queued panels per engine worker", ("engine",))
    jobs = registry.counter("repro_engine_jobs_total",
                            "panels executed per engine", ("engine",))
    steals = registry.counter("repro_engine_steals_total",
                              "panels stolen BY this engine", ("engine",))
    busy = registry.gauge("repro_engine_busy_fraction",
                          "wall busy fraction per engine", ("engine",))
    health = registry.gauge("repro_engine_health",
                            "EMA health score (1.0 = nominal)", ("engine",))
    quar = registry.gauge("repro_engine_quarantined",
                          "1 if the engine is quarantined", ("engine",))
    for name, es in st["engines"].items():
        eng.labels(name).set(es["queued"])
        jobs.labels(name).set_total(es["jobs"])
        steals.labels(name).set_total(es["steals"])
        busy.labels(name).set(es["busy_fraction"])
        if es.get("health") is not None:
            health.labels(name).set(es["health"])
        quar.labels(name).set(1.0 if es.get("quarantined") else 0.0)
    registry.gauge("repro_runtime_steal_rate",
                   "fraction of executed panels that were stolen").set(
        st["total_steals"] / st["total_jobs"] if st["total_jobs"] else 0.0)
    registry.counter("repro_runtime_submissions_total",
                     "jobset submissions").set_total(st["submissions"])
    registry.counter("repro_runtime_rebalances_total",
                     "hotplug/quarantine queue rebalances").set_total(
        st["rebalances"])
    registry.counter("repro_runtime_quarantines_total",
                     "self-healing quarantine trips").set_total(
        st["quarantines"])
    registry.counter("repro_runtime_retries_total",
                     "panel re-executions under the RetryPolicy").set_total(
        st.get("retries", 0))
    registry.counter("repro_runtime_worker_deaths_total",
                     "engine workers declared dead by the heartbeat "
                     "monitor").set_total(st.get("worker_deaths", 0))
    registry.counter("repro_runtime_orphan_reseeds_total",
                     "orphaned panels re-seeded after a worker "
                     "death").set_total(st.get("orphan_reseeds", 0))


def collect_server(srv, registry: MetricsRegistry = REGISTRY) -> None:
    """Feed the registry from ``ServeStats`` / ``TenantStats`` views and
    live queue/in-flight occupancy."""
    s = srv.stats
    registry.counter("repro_serve_tokens_total",
                     "decode tokens produced").set_total(s.tokens_out)
    registry.counter("repro_serve_prefills_total",
                     "prefills completed").set_total(s.prefills)
    registry.counter("repro_serve_decode_steps_total",
                     "decode steps executed").set_total(s.decode_steps)
    registry.counter("repro_serve_rejected_total",
                     "admission rejections").set_total(s.admission_rejects)
    registry.counter("repro_serve_shed_engagements_total",
                     "load-shed ladder engagements").set_total(
        s.shed_engagements)
    registry.counter("repro_serve_replayed_tokens_total",
                     "tokens recomputed from the journal on restore "
                     "(already delivered; not throughput)").set_total(
        getattr(s, "replayed_tokens", 0))
    registry.counter("repro_serve_snapshots_total",
                     "crash-consistent snapshots taken").set_total(
        getattr(s, "snapshots", 0))
    registry.counter("repro_serve_restores_total",
                     "successful snapshot+journal restores").set_total(
        getattr(s, "restores", 0))
    registry.gauge("repro_serve_shed_level",
                   "current shed ladder level").set(
        getattr(srv, "_shed_level", 0))
    registry.gauge("repro_serve_inflight",
                   "async in-flight window occupancy").set(
        len(getattr(srv, "_inflight", ()) or ()))
    registry.gauge("repro_serve_inflight_peak",
                   "peak in-flight window occupancy").set(s.inflight_peak)
    registry.gauge("repro_serve_pending",
                   "requests queued behind admission").set(
        len(srv.pending))
    tn = s.tenants or {}
    if tn:
        tok = registry.counter("repro_tenant_tokens_total",
                               "tokens per tenant", ("tenant",))
        adm = registry.counter("repro_tenant_admitted_total",
                               "admissions per tenant", ("tenant",))
        rej = registry.counter("repro_tenant_rejected_total",
                               "rejections per tenant", ("tenant",))
        wait = registry.counter("repro_tenant_queue_wait_seconds_total",
                                "cumulative admission queue wait",
                                ("tenant",))
        att = registry.gauge("repro_tenant_deadline_attainment",
                             "deadline hits / (hits+misses)", ("tenant",))
        for name, ts in sorted(tn.items()):
            tok.labels(name).set_total(ts.tokens_out)
            adm.labels(name).set_total(ts.admitted)
            rej.labels(name).set_total(ts.rejected)
            wait.labels(name).set_total(ts.queue_wait_s)
            if ts.deadline_hits + ts.deadline_misses:
                att.labels(name).set(ts.deadline_attainment)


def collect_calibrator(engine, registry: MetricsRegistry = REGISTRY) -> None:
    """Publish-count view over an engine's ``ActCalibrator.state()``:
    a shape is *published* once it has ``>= min_updates`` observations
    (i.e. ``scale_for`` starts returning a scale)."""
    cal = getattr(engine, "calibrator", None)
    if cal is None:
        return
    state = cal.state()
    published = sum(1 for sc in state.values()
                    if sc.updates >= cal.min_updates)
    registry.gauge("repro_calibrator_tracked_shapes",
                   "activation shapes under calibration",
                   ("engine",)).labels(engine.name).set(len(state))
    registry.gauge("repro_calibrator_published_shapes",
                   "shapes whose act scale is published",
                   ("engine",)).labels(engine.name).set(published)


def render_prometheus(*, runtime=None, server=None, engines=(),
                      registry: MetricsRegistry = REGISTRY) -> str:
    """Collect from the given views (if any) and render the registry in
    Prometheus text exposition format."""
    if runtime is not None:
        collect_runtime(runtime, registry)
        for eng in getattr(runtime, "engines", ()):
            collect_calibrator(eng, registry)
    if server is not None:
        collect_server(server, registry)
        if runtime is None and getattr(server, "runtime", None) is not None:
            collect_runtime(server.runtime, registry)
    for eng in engines:
        collect_calibrator(eng, registry)
    return registry.render()


# -------------------------------------------------------------- parsing

def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Minimal exposition-format parser (used by tests + acceptance):
    ``{metric_name: [({label: value}, sample_value), ...]}``.  Raises
    ``ValueError`` on malformed lines."""
    out: dict[str, list[tuple[dict, float]]] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        name, labelblob, raw = m.groups()
        labels = {}
        if labelblob:
            labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                      for k, v in label_re.findall(labelblob)}
        value = math.inf if raw == "+Inf" else float(raw)
        out.setdefault(name, []).append((labels, value))
    return out
