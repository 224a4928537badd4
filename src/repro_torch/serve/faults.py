"""Deterministic fault injection for the serving host loop.

A **fault trace** is a seeded, replayable schedule of failures the host
loop must survive, made of plain integers and floats that round-trip
through ``to_dict``/``from_dict``.  ``KINDS`` and ``make_trace`` are the JAX
package's, draw for draw, so a trace made by either package replays in the
other.

Fault kinds:

  * ``plan_exc``            — ``plan_tick`` raises; the sync driver replans
    inline (a degraded tick).
  * ``dispatch_transient``  — the device dispatch fails ``count`` times
    before succeeding; recovered by retry with backoff.
  * ``dispatch_persistent`` — the dispatch keeps failing past the retry
    budget; the tick is shed (no cursor advances, so every due frame is
    replanned next tick).
  * ``stall``               — the device hangs for ``delay_s`` inside
    ``step_finish``; the finish watchdog surfaces it.
  * ``nan_poison``          — one slot's finished image is replaced with
    NaNs.  The host's finite scan drops the frame and quarantines the slot,
    and the ``isfinite`` insert gate (``core.radiance_cache``) keeps
    non-finite colors out of the shared scene cache however they arise.
  * ``worker_death``        — a threaded driver's planner worker dies; the
    sync driver has no such seam and leaves it outstanding.
  * ``device_loss``         — a device drops out of a serving fleet; only a
    fleet driver consumes it, so a single-device driver leaves it
    outstanding.

The **injector** follows the NULL-object seam of ``obs.trace``: the manager
holds ``faults.NULL`` by default, every check is an attribute test, and the
unfaulted path does no extra work.  Events are consumed one-shot (``take``)
and recorded in ``fired``, so the ``serve.faults{kind=...}`` counters can be
held against the trace exactly.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque

import numpy as np
import torch

from ..core.camera import TENSOR_FIELDS

KINDS = ('plan_exc', 'dispatch_transient', 'dispatch_persistent', 'stall',
         'nan_poison', 'worker_death', 'device_loss')


class InjectedFault(RuntimeError):
    """Base class of all injected failures (never raised by real code)."""


class InjectedPlanError(InjectedFault):
    """An injected ``plan_tick`` exception."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure.

    ``tick``    : manager tick the event arms at (it fires at the first
                  opportunity at or after this tick)
    ``kind``    : one of ``KINDS``
    ``slot``    : preferred target slot for ``nan_poison`` (-1 = the lowest
                  slot rendering that tick, see ``FaultInjector.poison_slot``)
    ``count``   : failed attempts for ``dispatch_transient``
    ``delay_s`` : injected device delay for ``stall``
    """

    tick: int
    kind: str
    slot: int = -1
    count: int = 1
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f'unknown fault kind {self.kind!r} '
                             f'(expected one of {KINDS})')

    def to_dict(self) -> dict:
        return {'tick': self.tick, 'kind': self.kind, 'slot': self.slot,
                'count': self.count, 'delay_s': self.delay_s}

    @classmethod
    def from_dict(cls, d: dict) -> 'FaultEvent':
        return cls(tick=int(d['tick']), kind=str(d['kind']),
                   slot=int(d.get('slot', -1)), count=int(d.get('count', 1)),
                   delay_s=float(d.get('delay_s', 0.05)))


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A replayable failure schedule: ``events`` sorted by (tick, kind)."""

    seed: int
    events: tuple

    def to_dict(self) -> dict:
        return {'seed': self.seed,
                'events': [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> 'FaultTrace':
        return cls(seed=int(d['seed']),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d['events']))

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


def make_trace(kinds, ticks: int, *, seed: int = 0, rate: float = 0.05,
               slots: int = 1, stall_s: float = 0.05,
               transient_count: int = 1) -> FaultTrace:
    """A deterministic fault trace: per tick and per kind an independent
    Bernoulli(``rate``) draw, all from ``np.random.default_rng(seed)``."""
    kinds = tuple(kinds)
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f'unknown fault kind {k!r} '
                             f'(expected one of {KINDS})')
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f'fault rate must be in [0, 1], got {rate}')
    rng = np.random.default_rng(seed)
    events = []
    for tick in range(ticks):
        for kind in kinds:
            if rng.random() >= rate:
                continue
            events.append(FaultEvent(
                tick=tick, kind=kind,
                slot=int(rng.integers(0, max(1, slots))),
                count=transient_count, delay_s=stall_s))
    return FaultTrace(seed=seed, events=tuple(events))


class FaultInjector:
    """Consumes a ``FaultTrace`` against the live host loop.

    Events of each kind queue in tick order; ``take(kind, tick)`` pops the
    next one armed at or before ``tick`` (one-shot) and appends it to
    ``fired``.  An event armed on a tick where its seam is not reached (a
    dispatch fault on an idle tick, a poison with no output) fires at the
    next tick that reaches it.
    """

    enabled = True

    def __init__(self, trace: FaultTrace):
        self.trace = trace
        self._pending: dict[str, deque] = {k: deque() for k in KINDS}
        for ev in sorted(trace.events, key=lambda e: e.tick):
            self._pending[ev.kind].append(ev)
        self.fired: list[FaultEvent] = []

    def take(self, kind: str, tick: int):
        """Pop (and record) the next ``kind`` event armed at or before
        ``tick``, or None."""
        q = self._pending[kind]
        if q and q[0].tick <= tick:
            ev = q.popleft()
            self.fired.append(ev)
            return ev
        return None

    def peek(self, kind: str, tick: int) -> bool:
        q = self._pending[kind]
        return bool(q) and q[0].tick <= tick

    def fired_counts(self) -> dict:
        out: dict[str, int] = {}
        for e in self.fired:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def outstanding(self) -> dict:
        """Armed-but-unfired events per kind."""
        return {k: len(q) for k, q in self._pending.items() if q}

    @staticmethod
    def poison_slot(ev: FaultEvent, eligible) -> int:
        """The slot a poison event lands on: its preferred ``slot`` if
        eligible, else the lowest eligible slot (callers pass the slots that
        produced an output this tick)."""
        eligible = sorted(eligible)
        return ev.slot if ev.slot in eligible else eligible[0]


def poison_camera(cam):
    """A copy of ``cam`` with every floating tensor, and its host copy of
    the pose, replaced by NaN.  A test utility: it drives NaN through the
    real shade to show that the cache stays finite there.  It is not how
    ``nan_poison`` injects: what a NaN pose renders depends on the backend
    (the reference's misses come out NaN, the kernel path's black)."""
    def nan(x):
        return torch.full_like(x, float('nan')) if x.is_floating_point() \
            else x
    host = cam.host_pose
    if host is not None:
        host = tuple(np.full_like(h, np.nan) for h in host)
    return dataclasses.replace(
        cam, **{f: nan(getattr(cam, f)) for f in TENSOR_FIELDS},
        host_pose=host)


def account_unfired(injector, metrics=None) -> dict:
    """End-of-run accounting for events that never fired: one
    ``RuntimeWarning`` summarising the counts and a
    ``serve.faults_unfired{kind=...}`` counter per kind on ``metrics`` (an
    ``obs.metrics.Registry``; None skips the counters).  Returns the
    ``outstanding()`` dict."""
    left = injector.outstanding()
    if left:
        detail = ', '.join(f'{k}={n}' for k, n in sorted(left.items()))
        warnings.warn(
            f'fault trace finished with unfired events: {detail} '
            f'(driver never reached their seam — see FaultInjector docs)',
            RuntimeWarning, stacklevel=2)
        if metrics is not None:
            for kind, n in sorted(left.items()):
                metrics.counter('serve.faults_unfired', kind=kind).inc(n)
    return left


class _NullInjector:
    """No-op injector (the default): ``enabled`` is False and every check
    short-circuits."""

    enabled = False
    fired = ()

    def take(self, kind, tick):
        return None

    def peek(self, kind, tick):
        return False

    def fired_counts(self):
        return {}

    def outstanding(self):
        return {}


NULL = _NullInjector()
