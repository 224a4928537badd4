"""Open-loop serving traffic: arrival traces and per-viewer frame pacing.

A **traffic trace** is the host-loop's replayable input: per viewer, the
tick it arrives on and the pace at which it consumes frames (a pace-``p``
viewer renders one frame every ``p`` ticks — a 30 fps client against a
90 Hz tick, say).  Traces are plain integers, generated from a seeded RNG,
and round-trip through ``to_dict``/``from_dict`` — so any observed workload
can be recorded once and replayed bit-identically through the virtual-clock
driver (``repro_torch.serve.events.SyncDriver``).

Three arrival processes:

  * ``stagger`` — one viewer every ``stagger`` ticks (the legacy layout);
  * ``poisson`` — open-loop Poisson arrivals at ``rate`` viewers/tick
    (exponential inter-arrival gaps, floored to ticks): the
    "millions of independent users" model;
  * ``bursty``  — ``burst`` viewers land together every ``gap`` ticks, each
    burst jittered by up to ``jitter`` ticks: the flash-crowd /
    broadcast-start model that stresses admission and sort-on-admit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ('stagger', 'poisson', 'bursty')


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """A replayable arrival/pacing trace for ``viewers`` sessions.

    ``arrivals[i]`` is viewer ``i``'s arrival tick (non-decreasing),
    ``paces[i]`` its frame pace in ticks (>= 1).
    """

    kind: str
    seed: int
    arrivals: tuple
    paces: tuple

    @property
    def viewers(self) -> int:
        return len(self.arrivals)

    def to_dict(self) -> dict:
        return {'kind': self.kind, 'seed': self.seed,
                'arrivals': list(self.arrivals), 'paces': list(self.paces)}

    @classmethod
    def from_dict(cls, d: dict) -> 'TrafficTrace':
        return cls(kind=d['kind'], seed=int(d['seed']),
                   arrivals=tuple(int(a) for a in d['arrivals']),
                   paces=tuple(int(p) for p in d['paces']))


def _stagger_arrivals(viewers: int, stagger: int) -> list:
    return [i * stagger for i in range(viewers)]


def _poisson_arrivals(viewers: int, rate: float,
                      rng: np.random.Generator) -> list:
    if rate <= 0:
        raise ValueError(f'poisson arrivals need rate > 0, got {rate}')
    gaps = rng.exponential(1.0 / rate, size=viewers)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def _bursty_arrivals(viewers: int, burst: int, gap: int, jitter: int,
                     rng: np.random.Generator) -> list:
    if burst < 1 or gap < 1:
        raise ValueError(f'bursty arrivals need burst/gap >= 1, got '
                         f'{burst}/{gap}')
    arrivals = []
    for b in range(-(-viewers // burst)):
        base = b * gap + (int(rng.integers(0, jitter + 1)) if jitter else 0)
        arrivals.extend([base] * min(burst, viewers - len(arrivals)))
    return sorted(arrivals)


def make_trace(kind: str, viewers: int, *, seed: int = 0, rate: float = 0.5,
               burst: int = 4, gap: int = 8, jitter: int = 0,
               stagger: int = 2, pace: int = 1,
               pace_jitter: int = 0) -> TrafficTrace:
    """Generate a deterministic arrival/pacing trace.

    ``pace_jitter`` > 0 mixes client rates: viewer ``i`` gets a pace drawn
    uniformly from ``[pace, pace + pace_jitter]``, so the fleet carries
    fast and slow consumers on one tick clock.  Everything is drawn from
    ``np.random.default_rng(seed)`` — same arguments, same trace, always.
    """
    if kind not in KINDS:
        raise ValueError(f'unknown traffic kind {kind!r} '
                         f'(expected one of {KINDS})')
    if viewers < 1:
        raise ValueError('viewers must be >= 1')
    if pace < 1:
        raise ValueError('pace must be >= 1')
    rng = np.random.default_rng(seed)
    if kind == 'stagger':
        arrivals = _stagger_arrivals(viewers, stagger)
    elif kind == 'poisson':
        arrivals = _poisson_arrivals(viewers, rate, rng)
    else:
        arrivals = _bursty_arrivals(viewers, burst, gap, jitter, rng)
    if pace_jitter:
        paces = [pace + int(p)
                 for p in rng.integers(0, pace_jitter + 1, size=viewers)]
    else:
        paces = [pace] * viewers
    return TrafficTrace(kind=kind, seed=seed, arrivals=tuple(arrivals),
                        paces=tuple(paces))
