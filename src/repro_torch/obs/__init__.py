"""repro_torch.obs — observability for the heterogeneous runtime: the
ring-buffered span tracer with Chrome/Perfetto ``trace_event`` export
and the layer spans of the CNN path (:mod:`repro_torch.obs.trace`),
counters / gauges / fixed-bucket histograms with Prometheus text
exposition, fed at collect time from the
runtime's ``stats()`` and ``Telemetry`` views
(:mod:`repro_torch.obs.metrics`), and the flight recorder that dumps the
tracer's tail on quarantines and worker deaths
(:mod:`repro_torch.obs.flightrec`).

The package imports nothing from ``repro_torch.soc``,
``repro_torch.core`` or ``repro_torch.engines`` so every execution layer
can import it without cycles."""

from repro_torch.obs.flightrec import FlightRecorder
from repro_torch.obs.metrics import (MetricsRegistry, REGISTRY,
                                     parse_prometheus, render_prometheus)
from repro_torch.obs.trace import (EVENT_KINDS, SPAN_NAMES, TraceEvent,
                                   Tracer, get_default_tracer,
                                   load_chrome_trace, profiled_tracer,
                                   profiler_clock,
                                   set_default_tracer, span, trace_scope,
                                   validate_events)

__all__ = [
    "EVENT_KINDS", "FlightRecorder", "MetricsRegistry", "REGISTRY",
    "SPAN_NAMES", "TraceEvent", "Tracer", "get_default_tracer",
    "load_chrome_trace", "parse_prometheus",
    "profiled_tracer", "profiler_clock", "render_prometheus",
    "set_default_tracer", "span", "trace_scope", "validate_events",
]
