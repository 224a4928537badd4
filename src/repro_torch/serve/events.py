"""The serving host pipeline's event seam: tick plans and the driver.

The ``SessionManager`` tick decomposes into three operations (see
``repro_torch.serve.session``):

  * ``plan_tick``    — pure host planning: which slots evict, which pending
    sessions admit where, which slots render which cameras, plus the
    stepper's pose-cell sort plan;
  * ``apply_plan``   — atomic commit of the plan's admissions and evictions;
  * ``observe_tick`` — per-frame telemetry and cursor advance once the
    device outputs land.

``SyncDriver`` is the virtual-clock driver: it runs those operations
inline, one tick at a time, on a tick counter that is the clock, so
replaying an arrival trace (``repro_torch.serve.traffic``) reproduces the
same images, cache state and sort cadence.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """One tick's host decisions, computed ahead of the device step.

    evict : slots whose (finished) sessions leave before this tick
    admit : ``(slot, sid)`` placements, in the order the pending queue
            releases them
    cams  : ``{slot: Camera}`` for the slots that render this tick (a paced
            session skips ticks between its due frames; its slot stays
            occupied but renders nothing)
    sort_plan : the stepper's pose-cell sort plan
            (``BatchedStepper.plan_step``), or None for steppers without a
            host planning phase
    switches : ``(slot, sid)`` lane swaps for oversubscribed slots: the
            named (stashed) co-resident session becomes the slot's lane
            occupant before this tick renders; the outgoing occupant is
            stashed, or retired if it has finished
    """

    tick: int
    evict: tuple
    admit: tuple
    cams: dict
    sort_plan: object = None
    switches: tuple = ()


@dataclasses.dataclass(frozen=True)
class HostTiming:
    """Host-side cost attribution for one tick.

    host_ms    : wall-clock of the tick's host planning work
    overlap_ms : portion of ``host_ms`` that ran while the device window of
                 the concurrent tick was open; zero in the sync driver,
                 where planning runs inside the tick
    """

    host_ms: float = 0.0
    overlap_ms: float = 0.0


class SyncDriver:
    """Virtual-clock driver: plan -> apply -> step -> observe, inline, until
    every submitted session has completed, with a checkpoint at each tick
    boundary the manager asks for one.  No wall clock enters the control
    path."""

    def __init__(self, mgr):
        self.mgr = mgr

    def run_tick(self) -> int:
        return self.mgr.run_tick()

    def run(self, max_ticks: int = 100_000):
        mgr = self.mgr
        while not mgr.drained():
            self.run_tick()
            mgr.evict_finished()
            mgr.maybe_checkpoint()
            if mgr.tick >= max_ticks:
                raise RuntimeError('serve loop did not drain')
        return mgr.finished


DRIVERS = {'sync': SyncDriver}


def get_driver(name: str, mgr):
    try:
        return DRIVERS[name](mgr)
    except KeyError:
        raise ValueError(f'unknown serve driver {name!r} '
                         f'(expected one of {sorted(DRIVERS)})') from None
