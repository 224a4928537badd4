"""Typed metrics for the serving stack: counters, gauges, histograms and
per-tick series behind one registry.

The serving layers publish **named, typed** instruments here instead of
growing ad-hoc dict plumbing:

  * ``Counter``   — monotonic totals (``sort.executed`` per (scene, pose
    cell), ``serve.admitted`` / ``serve.evicted``, ``serve.paced_idle``);
  * ``Gauge``     — last-value samples (``serve.queue_depth``,
    ``cache.occupancy``, state-byte figures);
  * ``Histogram`` — raw-sample distributions with exact percentiles
    (``serve.tick_latency_ms``, per-scene ``cache.hit_rate``,
    ``rc.saved_frac`` — the trim/compaction saving);
  * ``Series``    — per-tick time series keyed by the virtual tick clock.
    ``SessionManager.observe_tick`` publishes every tick-log field here via
    :func:`publish_tick`, and :func:`tick_rollup_from_metrics` recomputes
    ``repro_torch.serve.telemetry.tick_rollup`` **bit-compatibly** from
    the registry — the registry is the
    superset the legacy dict rollup is now a view of.

Naming convention: dot-separated ``subsystem.metric`` (``serve.*`` manager
/ admission, ``sort.*`` pose-cell scheduler, ``cache.*`` radiance cache,
``rc.*`` redundancy accounting, ``tick.*`` reserved for the per-tick
series), with low-cardinality labels (``scene=``, ``cell=``) carried on the
instrument key, Prometheus-style: ``sort.executed{cell=17,scene=0}``.

A name is permanently typed: re-registering ``serve.frames`` as a gauge
after it existed as a counter raises — silent type drift is how rollups
rot.  All mutation goes through the registry lock, so the threaded
driver's planner worker may publish concurrently with the main loop.
"""
from __future__ import annotations

import json
import threading

import numpy as np


class Counter:
    """Monotonic accumulator."""

    kind = 'counter'
    __slots__ = ('name', 'description', 'unit', 'value')

    def __init__(self, name: str, description: str = '', unit: str = ''):
        self.name = name
        self.description = description
        self.unit = unit
        self.value = 0

    def inc(self, v=1) -> None:
        if v < 0:
            raise ValueError(f'counter {self.name} cannot decrease (inc {v})')
        self.value += v

    def snapshot(self) -> dict:
        return {'type': self.kind, 'value': self.value}


class Gauge:
    """Last-value sample (plus the observed min/max envelope)."""

    kind = 'gauge'
    __slots__ = ('name', 'description', 'unit', 'value', 'min', 'max')

    def __init__(self, name: str, description: str = '', unit: str = ''):
        self.name = name
        self.description = description
        self.unit = unit
        self.value = None
        self.min = None
        self.max = None

    def set(self, v) -> None:
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def snapshot(self) -> dict:
        return {'type': self.kind, 'value': self.value,
                'min': self.min, 'max': self.max}


class Histogram:
    """Raw-sample distribution: exact count/sum/percentiles.

    Samples are kept verbatim (serving runs are thousands of ticks, not
    millions of requests); ``percentile`` matches ``np.percentile`` so the
    numbers line up with ``tick_rollup``'s p50/p95.
    """

    kind = 'histogram'
    __slots__ = ('name', 'description', 'unit', 'samples')

    def __init__(self, name: str, description: str = '', unit: str = ''):
        self.name = name
        self.description = description
        self.unit = unit
        self.samples: list = []

    def observe(self, v) -> None:
        self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self):
        return sum(self.samples)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples, np.float64), p))

    def snapshot(self) -> dict:
        return {'type': self.kind, 'count': self.count,
                'sum': float(self.sum) if self.samples else 0.0,
                'p50': self.percentile(50), 'p95': self.percentile(95),
                'p99': self.percentile(99)}


class Series:
    """Per-tick samples ``(tick, value)`` on the virtual tick clock."""

    kind = 'series'
    __slots__ = ('name', 'description', 'unit', 'samples')

    def __init__(self, name: str, description: str = '', unit: str = ''):
        self.name = name
        self.description = description
        self.unit = unit
        self.samples: list = []

    def record(self, tick: int, value) -> None:
        self.samples.append((tick, value))

    def snapshot(self) -> dict:
        return {'type': self.kind, 'ticks': len(self.samples),
                'last': self.samples[-1][1] if self.samples else None}


class Registry:
    """Get-or-create instrument registry, keyed by (name, labels)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ','.join(f'{k}={labels[k]}' for k in sorted(labels))
        return f'{name}{{{inner}}}'

    def _get(self, cls, name: str, description: str, unit: str,
             labels: dict):
        key = self._key(name, labels)
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = self._metrics[key] = cls(key, description, unit)
            elif not isinstance(inst, cls):
                raise TypeError(f'metric {key!r} already registered as '
                                f'{inst.kind}, requested {cls.kind}')
            return inst

    def counter(self, name: str, description: str = '', unit: str = '',
                **labels) -> Counter:
        return self._get(Counter, name, description, unit, labels)

    def gauge(self, name: str, description: str = '', unit: str = '',
              **labels) -> Gauge:
        return self._get(Gauge, name, description, unit, labels)

    def histogram(self, name: str, description: str = '', unit: str = '',
                  **labels) -> Histogram:
        return self._get(Histogram, name, description, unit, labels)

    def series(self, name: str, description: str = '', unit: str = '',
               **labels) -> Series:
        return self._get(Series, name, description, unit, labels)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._metrics

    def __getitem__(self, key: str):
        with self._lock:
            return self._metrics[key]

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-serializable view of every instrument (``--metrics-out``)."""
        with self._lock:
            items = list(self._metrics.items())
        return {key: _jsonable(inst.snapshot()) for key, inst in items}

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.snapshot(), **kwargs)


def _jsonable(obj):
    """Coerce numpy scalars and 0-d tensors (telemetry defers device
    syncs) so the snapshot dumps cleanly."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    if hasattr(obj, 'item'):
        return obj.item()
    return float(obj)


# -- the tick-series mirror of SessionManager.tick_log ----------------------

TICK_PREFIX = 'tick.'
_KERNEL_PREFIX = TICK_PREFIX + 'kernel_ms.'


def publish_tick(registry: Registry, entry: dict) -> None:
    """Mirror one ``SessionManager.tick_log`` entry into per-tick series.

    Scalar fields land verbatim on ``tick.<field>`` (values are stored
    as-is — possibly still-unsynced device scalars, exactly like the dict
    path; ``tick_rollup`` is where they become floats), the nested
    ``kernel_ms`` breakdown on ``tick.kernel_ms.<stage>``.  A ``None``
    ``kernel_ms`` (unprofiled tick) records nothing, matching the dict
    path's falsy-skip.
    """
    tick = entry['tick']
    for key, value in entry.items():
        if key == 'tick':
            continue
        if key == 'kernel_ms':
            if value:
                for stage, ms in value.items():
                    registry.series(_KERNEL_PREFIX + stage).record(tick, ms)
            continue
        registry.series(TICK_PREFIX + key).record(tick, value)


def tick_log_from_registry(registry: Registry) -> list:
    """Reconstruct the tick log from the registry's ``tick.*`` series —
    the inverse of :func:`publish_tick`, up to dict key order."""
    fields: dict[str, dict] = {}
    kernel: dict[str, dict] = {}
    for key in registry.names():
        if key.startswith(_KERNEL_PREFIX):
            kernel[key[len(_KERNEL_PREFIX):]] = dict(registry[key].samples)
        elif key.startswith(TICK_PREFIX):
            fields[key[len(TICK_PREFIX):]] = dict(registry[key].samples)
    ticks = sorted({t for by_tick in fields.values() for t in by_tick})
    log = []
    for t in ticks:
        entry = {'tick': t}
        for field, by_tick in fields.items():
            if t in by_tick:
                entry[field] = by_tick[t]
        kms = {stage: by_tick[t] for stage, by_tick in kernel.items()
               if t in by_tick}
        entry['kernel_ms'] = kms or None
        log.append(entry)
    return log


def tick_rollup_from_metrics(registry: Registry,
                             warmup_ticks: int = 0) -> dict:
    """``repro_torch.serve.telemetry.tick_rollup`` recomputed from the registry's
    tick series.  Bit-identical to the dict path on the same run: the
    series hold the tick-log values verbatim and the rollup arithmetic is
    literally shared."""
    from ..serve.telemetry import tick_rollup   # avoid an import cycle
    return tick_rollup(tick_log_from_registry(registry),
                       warmup_ticks=warmup_ticks)
