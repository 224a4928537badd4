"""Observability for the serving stack: span tracing and typed metrics.

  * ``trace``   — span/instant tracer with host / host-worker / device
    tracks (``NULL`` no-op tracer by default);
  * ``metrics`` — counter/gauge/histogram/series registry that the steppers
    and ``SessionManager`` publish into.

This package imports nothing from ``repro_torch.serve`` at module scope.
"""
from .metrics import (Counter, Gauge, Histogram, Registry, Series,
                      publish_tick, tick_log_from_registry,
                      tick_rollup_from_metrics)
from .trace import (NULL, TRACK_DEVICE, TRACK_HOST, TRACK_WORKER, TraceEvent,
                    Tracer, span_structure)

__all__ = [
    'Tracer', 'TraceEvent', 'NULL', 'span_structure',
    'TRACK_HOST', 'TRACK_WORKER', 'TRACK_DEVICE',
    'Counter', 'Gauge', 'Histogram', 'Series', 'Registry',
    'publish_tick', 'tick_log_from_registry', 'tick_rollup_from_metrics',
]
