"""Low-overhead span/instant tracing for the serving host pipeline.

A :class:`Tracer` records three event shapes onto named **tracks** (host,
host-worker, device — each exported as its own Perfetto/`chrome://tracing`
thread lane in a Chrome trace-event export):

  * **context-manager spans** — ``with tracer.span('plan_tick', tick=t):``
    times host-side work on the calling thread's track.  Nesting depth is
    maintained per (thread, track) so the exported trace shows the real
    call structure (``tick`` > ``plan_tick`` / ``apply_plan`` /
    ``observe_tick``);
  * **explicit complete spans** — ``tracer.complete(name, t0, t1,
    track='device')`` for intervals whose begin/end straddle calls, e.g.
    the device window of an async shade (``step_dispatch`` records the
    dispatch time, ``step_finish`` closes the span once
    ``block_until_ready`` returns) and the sampled kernel-stage breakdown;
  * **instants** — ``tracer.instant('admit', slot=3, sid=7)`` for traffic
    events (arrival / admit / evict / pace) that have no duration.

Determinism contract: under the virtual-clock ``SyncDriver`` the serving
control flow is a pure function of the submitted trace, so the *structure*
of the recorded spans — per-track (name, depth, args) sequences, exposed by
:func:`span_structure` — is bit-identical across replays.  Timestamps are
wall-clock and of course differ; they never enter the structure.

Overhead: the module-level :data:`NULL` tracer is the default everywhere —
its ``span`` returns one shared no-op context manager and ``complete`` /
``instant`` are empty methods, so uninstrumented serving pays a single
attribute lookup per site.  A live tracer appends one small tuple per
event under a lock (the threaded driver's planner worker and the main
thread both record).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple, Optional

# Event phases, mirroring the Chrome trace-event vocabulary the exporter
# targets: 'X' = complete span (ts + dur), 'i' = instant.
PH_SPAN = 'X'
PH_INSTANT = 'i'

# Canonical track names.  Spans recorded without an explicit track land on
# the calling thread's default: the main thread is the serving loop
# ('host'); any other thread is host planning work ('host-worker' — the
# ThreadedDriver's planner).  Device windows are always explicit.
TRACK_HOST = 'host'
TRACK_WORKER = 'host-worker'
TRACK_DEVICE = 'device'


class TraceEvent(NamedTuple):
    """One recorded event.  ``ts``/``dur`` are seconds on the tracer's
    clock (perf_counter by default); ``depth`` is the span-nesting level
    within its track (0 = top level); ``args`` is a tuple of sorted
    (key, value) pairs — deterministic under replay by construction, the
    callers only attach control-flow values (tick numbers, slots, counts),
    never wall-clock readings."""

    ph: str
    name: str
    track: str
    ts: float
    dur: float
    depth: int
    args: tuple


class _Span:
    """Reusable enter/exit handle for one context-manager span."""

    __slots__ = ('_tracer', '_name', '_track', '_args', '_t0')

    def __init__(self, tracer: 'Tracer', name: str, track: str, args: tuple):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        tr = self._tracer
        tr._push(self._track)
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr._clock()
        depth = tr._pop(self._track)
        tr._record(TraceEvent(PH_SPAN, self._name, self._track,
                              self._t0, t1 - self._t0, depth, self._args))
        return False


class Tracer:
    """Collects :class:`TraceEvent` records; thread-safe."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._events: list[TraceEvent] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- per-(thread, track) nesting depth ---------------------------------

    def _depths(self) -> dict:
        d = getattr(self._local, 'depths', None)
        if d is None:
            d = self._local.depths = {}
        return d

    def _push(self, track: str) -> None:
        d = self._depths()
        d[track] = d.get(track, 0) + 1

    def _pop(self, track: str) -> int:
        d = self._depths()
        d[track] -= 1
        return d[track]

    def _default_track(self) -> str:
        if threading.current_thread() is threading.main_thread():
            return TRACK_HOST
        return TRACK_WORKER

    def _record(self, ev: TraceEvent) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API ------------------------------------------------------

    def span(self, name: str, track: Optional[str] = None, **args) -> _Span:
        """Context manager timing a host-side span on ``track`` (default:
        the calling thread's track)."""
        return _Span(self, name, track or self._default_track(),
                     tuple(sorted(args.items())))

    def complete(self, name: str, t0: float, t1: float,
                 track: str = TRACK_DEVICE, depth: int = 0, **args) -> None:
        """Record a span whose begin/end were measured explicitly (seconds
        on this tracer's clock) — device windows, sampled kernel stages."""
        self._record(TraceEvent(PH_SPAN, name, track, t0, max(0.0, t1 - t0),
                                depth, tuple(sorted(args.items()))))

    def instant(self, name: str, track: Optional[str] = None, **args) -> None:
        self._record(TraceEvent(PH_INSTANT, name,
                                track or self._default_track(),
                                self._clock(), 0.0, 0,
                                tuple(sorted(args.items()))))

    # -- reading ------------------------------------------------------------

    @property
    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullTracer:
    """No-op tracer: the default when observability is off."""

    enabled = False
    events: list = []
    _null_span = _NullSpan()

    def span(self, name, track=None, **args):
        return self._null_span

    def complete(self, name, t0, t1, track=TRACK_DEVICE, depth=0, **args):
        pass

    def instant(self, name, track=None, **args):
        pass

    def clear(self):
        pass


NULL = _NullTracer()


def span_structure(events) -> dict:
    """The wall-clock-free shape of a trace: per-track tuples of
    ``(ph, name, depth, args)`` in record order.  Two SyncDriver replays of
    the same traffic trace must produce equal structures — the determinism
    oracle."""
    out: dict[str, list] = {}
    for ev in events:
        out.setdefault(ev.track, []).append(
            (ev.ph, ev.name, ev.depth, ev.args))
    return {track: tuple(seq) for track, seq in out.items()}
