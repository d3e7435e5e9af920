"""repro_torch.obs — observability: the ring-buffered span tracer with
Chrome/Perfetto ``trace_event`` export (:mod:`repro_torch.obs.trace`).

The package imports nothing from ``repro_torch.core`` or
``repro_torch.engines`` so every execution layer can import it without
cycles."""

from repro_torch.obs.trace import (EVENT_KINDS, TraceEvent, Tracer,
                                   get_default_tracer, load_chrome_trace,
                                   set_default_tracer, trace_scope,
                                   validate_events)

__all__ = [
    "EVENT_KINDS", "TraceEvent", "Tracer", "get_default_tracer",
    "load_chrome_trace", "set_default_tracer", "trace_scope",
    "validate_events",
]
