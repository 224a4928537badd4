"""Observability for the serving stack: span tracing, typed metrics,
Perfetto export.

  * ``trace``   — span/instant tracer with host / host-worker / device
    tracks (``NULL`` no-op tracer by default);
  * ``export``  — Chrome trace-event JSON (Perfetto / ``chrome://tracing``)
    serialization and schema validation;
  * ``metrics`` — counter/gauge/histogram/series registry that the steppers
    and ``SessionManager`` publish into.

This package imports nothing from ``repro_torch.serve`` at module scope.
"""
from .export import (to_chrome_trace, track_spans, validate_chrome_trace,
                     write_trace)
from .metrics import (Counter, Gauge, Histogram, Registry, Series,
                      publish_tick, tick_log_from_registry,
                      tick_rollup_from_metrics)
from .trace import (NULL, TRACK_DEVICE, TRACK_HOST, TRACK_WORKER, TraceEvent,
                    Tracer, span_structure)

__all__ = [
    'Tracer', 'TraceEvent', 'NULL', 'span_structure',
    'TRACK_HOST', 'TRACK_WORKER', 'TRACK_DEVICE',
    'to_chrome_trace', 'write_trace', 'validate_chrome_trace', 'track_spans',
    'Counter', 'Gauge', 'Histogram', 'Series', 'Registry',
    'publish_tick', 'tick_log_from_registry', 'tick_rollup_from_metrics',
]
