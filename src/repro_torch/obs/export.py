"""Chrome trace-event export: load the serving trace in Perfetto.

Converts a :class:`repro_torch.obs.trace.Tracer`'s events into the Chrome
trace-event JSON object format — ``{"traceEvents": [...],
"displayTimeUnit": "ms"}`` — loadable in https://ui.perfetto.dev or
``chrome://tracing``.  Each tracer track becomes its own thread lane
(``tid``) under one process, named by ``M``-phase metadata events, so the
threaded driver's plan(t+1) ∥ device(t) overlap shows as a ``host-worker``
span under an open ``device`` span instead of a single ``host_overlap``
scalar.

Timestamps are exported in microseconds relative to the earliest event
(Chrome's unit), durations likewise; span nesting follows from timestamp
containment per lane, which matches the tracer's per-thread span stack by
construction.
"""
from __future__ import annotations

import json
from typing import Iterable

from .trace import (PH_INSTANT, PH_SPAN, TRACK_DEVICE, TRACK_HOST,
                    TRACK_WORKER, TraceEvent, Tracer)

PID = 1
PROCESS_NAME = 'repro_torch.serve'
# Stable lane ordering for the canonical tracks; unknown tracks follow.
_TRACK_ORDER = {TRACK_HOST: 1, TRACK_WORKER: 2, TRACK_DEVICE: 3}


def _track_tids(events: Iterable[TraceEvent]) -> dict:
    tracks = sorted({ev.track for ev in events},
                    key=lambda t: (_TRACK_ORDER.get(t, 99), t))
    return {track: _TRACK_ORDER.get(track, 10 + i)
            for i, track in enumerate(tracks)}


def to_chrome_trace(events: Iterable[TraceEvent],
                    process_name: str = PROCESS_NAME) -> dict:
    """Build the Chrome trace-event JSON object for ``events``."""
    events = list(events)
    tids = _track_tids(events)
    t_base = min((ev.ts for ev in events), default=0.0)
    out = [{'ph': 'M', 'name': 'process_name', 'pid': PID, 'tid': 0,
            'args': {'name': process_name}}]
    for track, tid in tids.items():
        out.append({'ph': 'M', 'name': 'thread_name', 'pid': PID,
                    'tid': tid, 'args': {'name': track}})
        out.append({'ph': 'M', 'name': 'thread_sort_index', 'pid': PID,
                    'tid': tid, 'args': {'sort_index': tid}})
    for ev in events:
        rec = {
            'ph': ev.ph,
            'name': ev.name,
            'cat': ev.track,
            'ts': (ev.ts - t_base) * 1e6,
            'pid': PID,
            'tid': tids[ev.track],
            'args': dict(ev.args),
        }
        if ev.ph == PH_SPAN:
            rec['dur'] = ev.dur * 1e6
        elif ev.ph == PH_INSTANT:
            rec['s'] = 't'   # thread-scoped instant
        out.append(rec)
    return {'traceEvents': out, 'displayTimeUnit': 'ms'}


def write_trace(path: str, tracer_or_events,
                process_name: str = PROCESS_NAME) -> dict:
    """Write a tracer's events as Chrome trace JSON; returns the payload."""
    events = (tracer_or_events.events
              if isinstance(tracer_or_events, Tracer) else tracer_or_events)
    payload = to_chrome_trace(events, process_name=process_name)
    with open(path, 'w') as f:
        json.dump(payload, f)
    return payload


def validate_chrome_trace(payload: dict) -> list:
    """Schema-check a Chrome trace-event JSON object; returns the event
    list.  Raises ``ValueError`` naming the first malformed record (the
    loadability check that tests and the CLI share; Perfetto itself is the
    authority)."""
    if not isinstance(payload, dict) or 'traceEvents' not in payload:
        raise ValueError('trace must be a JSON object with "traceEvents"')
    events = payload['traceEvents']
    if not isinstance(events, list):
        raise ValueError('"traceEvents" must be a list')
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f'traceEvents[{i}] is not an object')
        for field in ('ph', 'name', 'pid', 'tid'):
            if field not in ev:
                raise ValueError(f'traceEvents[{i}] missing {field!r}')
        if ev['ph'] == PH_SPAN:
            for field in ('ts', 'dur'):
                if not isinstance(ev.get(field), (int, float)) \
                        or ev[field] < 0:
                    raise ValueError(
                        f'traceEvents[{i}] ({ev["name"]}): bad {field!r}')
        elif ev['ph'] == PH_INSTANT:
            if not isinstance(ev.get('ts'), (int, float)):
                raise ValueError(
                    f'traceEvents[{i}] ({ev["name"]}): bad "ts"')
        elif ev['ph'] != 'M':
            raise ValueError(f'traceEvents[{i}]: unknown phase {ev["ph"]!r}')
    return events


def track_spans(payload: dict, track: str) -> list:
    """The ``(ts, ts + dur, name, args)`` complete spans of one named track
    of an exported trace, in timestamp order (what overlap checks read)."""
    events = validate_chrome_trace(payload)
    tid = next((ev['tid'] for ev in events
                if ev['ph'] == 'M' and ev['name'] == 'thread_name'
                and ev['args'].get('name') == track), None)
    if tid is None:
        return []
    spans = [(ev['ts'], ev['ts'] + ev['dur'], ev['name'], ev.get('args', {}))
             for ev in events if ev['ph'] == PH_SPAN and ev['tid'] == tid]
    return sorted(spans, key=lambda s: s[0])
