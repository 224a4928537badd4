"""Viewer sessions and the slot-based session manager.

A fixed number of render slots, a queue of pending viewers with arrival
ticks, admit-on-free-slot and evict-on-completion.  A viewer session is a
camera trajectory (one camera per frame) plus its telemetry; slots hold the
sessions that are live, and the stepper advances every live slot one frame
per tick.

Sessions carry a ``scene_id``.  When the stepper serves
``viewers_per_scene > 1`` slots per scene block, a session is admitted only
into a free slot of its scene's block, so co-scene viewers land where they
share the block's cache and sort pool.  With one viewer per scene,
admission is plain FIFO over all free slots.

A tick is three operations: ``plan_tick`` (pure planning), ``apply_plan``
(atomic commit of admissions and evictions under the manager lock) and
``observe_tick`` (telemetry and cursor advance).  ``run_tick`` composes them
inline with the stepper's ``step_dispatch``/``step_finish``;
``run(driver='sync')`` drives ticks until every session has finished.

**Frame pacing**: a session with ``pace = p`` consumes one frame every
``p`` ticks counted from its admission; its slot stays occupied on the
ticks between.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Optional

from ..core.camera import Camera
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .events import HostTiming, TickPlan, get_driver
from .telemetry import SessionTelemetry


@dataclasses.dataclass
class ViewerSession:
    """One viewer's camera stream: frames are consumed front to back.

    ``scene_id`` names the scene this viewer watches; viewers sharing it
    may share that scene's radiance cache and speculative sorts.  ``pace``
    is the frame interval in ticks (>= 1): a pace-``p`` viewer renders on
    ticks ``admitted_tick + k * p`` only.
    """

    sid: int
    cams: list          # list[Camera], one per frame
    arrival_tick: int = 0
    cursor: int = 0
    scene_id: int = 0
    pace: int = 1
    telemetry: Optional[SessionTelemetry] = None

    def __post_init__(self):
        if self.pace < 1:
            raise ValueError(f'session pace must be >= 1, got {self.pace}')
        if self.telemetry is None:
            self.telemetry = SessionTelemetry(sid=self.sid,
                                              arrival_tick=self.arrival_tick)

    @property
    def done(self) -> bool:
        return self.cursor >= len(self.cams)


class SessionManager:
    """Admit and evict viewers over a fixed set of render slots.

    ``stepper`` has the ``admit(slot)`` / ``step_dispatch`` /
    ``step_finish`` interface of ``repro_torch.serve.stepper``; the manager
    owns which sessions sit in which slots and feeds their per-frame stats
    into telemetry.  Placement changes (``apply_plan``, ``observe_tick``,
    ``evict_finished``) hold ``self._lock``, and
    ``snapshot()`` reads under it.

    ``max_pending`` bounds the admission backlog: a session submitted to a
    full queue is shed (kept in ``self.shed``, counted in ``serve.shed``).
    """

    def __init__(self, stepper, slots: int, tracer=None,
                 metrics: Optional[obs_metrics.Registry] = None,
                 max_pending: Optional[int] = None):
        self.stepper = stepper
        self.slots = slots
        # one tracer and registry for the manager and its stepper
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.metrics = metrics if metrics is not None else \
            obs_metrics.Registry()
        stepper.tracer = self.tracer
        stepper.metrics = self.metrics
        self.max_pending = max_pending
        self.shed: list[ViewerSession] = []
        self.viewers_per_scene = getattr(stepper, 'viewers_per_scene', 1)
        self.num_scenes = max(1, slots // self.viewers_per_scene)
        self.slot_session: list[Optional[ViewerSession]] = [None] * slots
        self.pending: deque[ViewerSession] = deque()
        self.finished: list[ViewerSession] = []
        self.tick = 0
        self._lock = threading.Lock()
        # host planning spent on zero-frame ticks (arrival gaps, paced idle
        # ticks) carries into the next logged entry
        self._carry_host_ms = 0.0
        self._carry_overlap_ms = 0.0
        # per rendered tick: {'tick', 'frames', 'sorted_slots', 'sort_ms',
        # 'shade_ms', 'latency_ms', 'host_ms', 'overlap_ms', 'kernel_ms'}
        # plus the stepper's state metrics
        self.tick_log: list[dict] = []

    # -- lifecycle ---------------------------------------------------------

    def submit(self, session: ViewerSession) -> bool:
        """Queue a session for admission; with ``max_pending`` set, a full
        backlog sheds it instead.  Returns whether it was accepted."""
        with self._lock:
            accepted = (self.max_pending is None
                        or len(self.pending) < self.max_pending)
            if accepted:
                self.pending.append(session)
            else:
                self.shed.append(session)
        if not accepted:
            self.metrics.counter(
                'serve.shed',
                'sessions rejected by the admission backlog bound').inc()
            self.tracer.instant('shed', sid=session.sid,
                                arrival_tick=session.arrival_tick)
            return False
        self.tracer.instant('arrival', sid=session.sid,
                            arrival_tick=session.arrival_tick)
        return True

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slot_session) if s is None]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slot_session) if s is not None]

    def _scene_block(self, scene_id: int) -> range:
        """Slot range of a session's scene block (scene ids beyond the
        stepper's scene count wrap: the block is a cache domain)."""
        c = scene_id % self.num_scenes
        v = self.viewers_per_scene
        return range(c * v, (c + 1) * v)

    def _admit_into(self, slot: int, sess: ViewerSession) -> None:
        sess.telemetry.admitted_tick = self.tick
        self.slot_session[slot] = sess
        self.stepper.admit(slot)

    def evict_finished(self) -> list[int]:
        with self._lock:
            evicted = []
            for slot, sess in enumerate(self.slot_session):
                if sess is not None and sess.done:
                    sess.telemetry.finished_tick = self.tick
                    self.finished.append(sess)
                    self.slot_session[slot] = None
                    self._release_slot(slot)
                    evicted.append(slot)
            return evicted

    def _release_slot(self, slot: int) -> None:
        """Tell the stepper the slot no longer hosts a viewer, so a dynamic
        pool can stop protecting its sort entry."""
        self.stepper.release(slot)

    # -- the host pipeline: plan / apply / observe -------------------------

    def _frame_due(self, sess: ViewerSession, tick: int) -> bool:
        """Does this admitted session consume a frame on ``tick``?"""
        return (tick - sess.telemetry.admitted_tick) % sess.pace == 0

    def plan_tick(self, tick: Optional[int] = None) -> TickPlan:
        """The next tick's host decisions, computed without mutating
        anything: evictions, admissions, the cameras of the slots that
        render, and the stepper's pose-cell sort plan against the
        post-admission active set."""
        tick = self.tick if tick is None else tick
        with self.tracer.span('plan_tick', tick=tick):
            evict = tuple(slot for slot, sess in enumerate(self.slot_session)
                          if sess is not None and sess.done)
            free = sorted(set(self.free_slots()) | set(evict))
            placements = self._plan_admissions(free, tick)
            admit = tuple((slot, sess.sid) for slot, sess in placements)
            admitted_slots = {slot for slot, _ in admit}
            cams: dict[int, Camera] = {}
            for slot, sess in enumerate(self.slot_session):
                if sess is None or slot in evict or slot in admitted_slots:
                    continue
                if self._frame_due(sess, tick):
                    cams[slot] = sess.cams[sess.cursor]
            for slot, sess in placements:
                cams[slot] = sess.cams[0]
            sort_plan = None
            plan_step = getattr(self.stepper, 'plan_step', None)
            if plan_step is not None:
                sort_plan = plan_step(cams, pending_admits=admitted_slots)
            return TickPlan(tick=tick, evict=evict, admit=admit, cams=cams,
                            sort_plan=sort_plan)

    def _plan_admissions(self, free: list, tick: int) -> list:
        """``(slot, session)`` placements over a hypothetical free-slot
        list, in pending-queue order, without popping anything: FIFO over
        the free slots, or, with scene blocks, FIFO per admissible session
        (a session whose block is full waits without blocking later
        sessions bound for other scenes)."""
        with self._lock:
            pending = list(self.pending)
        placements = []
        if self.viewers_per_scene == 1:
            for slot, sess in zip(free, itertools.islice(pending, len(free))):
                if sess.arrival_tick > tick:
                    break
                placements.append((slot, sess))
            return placements
        remaining = set(free)
        for sess in pending:
            if sess.arrival_tick > tick:
                continue
            block = [i for i in self._scene_block(sess.scene_id)
                     if i in remaining]
            if block:
                placements.append((block[0], sess))
                remaining.discard(block[0])
        return placements

    def apply_plan(self, plan: TickPlan) -> None:
        """Commit a plan's evictions and admissions atomically: a session is
        either fully pending or fully admitted (placed, stepper slot reset,
        ``admitted_tick`` stamped) in any concurrent view."""
        with self.tracer.span('apply_plan', tick=plan.tick,
                              admits=len(plan.admit),
                              evicts=len(plan.evict)), self._lock:
            if plan.tick != self.tick:
                raise RuntimeError(f'stale plan: tick {plan.tick} applied at '
                                   f'manager tick {self.tick}')
            for slot in plan.evict:
                sess = self.slot_session[slot]
                if sess is None or not sess.done:
                    raise RuntimeError(f'plan evicts slot {slot} whose '
                                       f'session is not finished')
                sess.telemetry.finished_tick = plan.tick
                self.finished.append(sess)
                self.slot_session[slot] = None
                self._release_slot(slot)
                self.tracer.instant('evict', slot=slot, sid=sess.sid,
                                    tick=plan.tick)
            self.metrics.counter(
                'serve.evicted', 'sessions leaving their slot').inc(
                    len(plan.evict))
            for slot, sid in plan.admit:
                if self.slot_session[slot] is not None:
                    raise RuntimeError(f'plan admits into occupied slot '
                                       f'{slot}')
                sess = next((s for s in self.pending if s.sid == sid), None)
                if sess is None:
                    raise RuntimeError(f'planned session {sid} not pending')
                self.pending.remove(sess)
                self._admit_into(slot, sess)
                self.tracer.instant('admit', slot=slot, sid=sid,
                                    tick=plan.tick)
            self.metrics.counter(
                'serve.admitted', 'sessions placed into a slot').inc(
                    len(plan.admit))
            self.metrics.gauge(
                'serve.queue_depth', 'pending sessions after admission').set(
                    len(self.pending))

    def observe_tick(self, plan: TickPlan, outputs: dict,
                     host: Optional[HostTiming] = None) -> int:
        """Record a completed tick: per-frame telemetry, cursor advance, the
        tick log entry (mirrored into the registry's ``tick.*`` series) and
        the clock advance to ``plan.tick + 1``."""
        with self.tracer.span('observe_tick', tick=plan.tick,
                              frames=len(outputs)), self._lock:
            for slot, (_image, stats, timing) in outputs.items():
                sess = self.slot_session[slot]
                hit_rate = float(stats.hit_rate)
                saved_frac = float(stats.saved_frac)
                sess.telemetry.observe_frame(
                    latency_s=timing.latency_s,
                    hit_rate=hit_rate,
                    saved_frac=saved_frac,
                    sorted_flag=float(stats.sorted_this_frame),
                    sort_ms=timing.sort_ms,
                    shade_ms=timing.shade_ms)
                sess.cursor += 1
                self.metrics.histogram(
                    'cache.hit_rate', 'per-frame RC hit rate',
                    scene=sess.scene_id).observe(hit_rate)
                self.metrics.histogram(
                    'rc.saved_frac', 'integration skipped via RC',
                    scene=sess.scene_id).observe(saved_frac)
            # occupied slot-ticks that rendered nothing (pace gaps, done
            # sessions awaiting eviction)
            idle = (sum(1 for s in self.slot_session if s is not None)
                    - len(outputs))
            if idle > 0:
                self.metrics.counter(
                    'serve.paced_idle',
                    'occupied slot-ticks that rendered no frame').inc(idle)
                self.tracer.instant('pace', tick=plan.tick, idle_slots=idle)
            self.metrics.counter('serve.frames',
                                 'frames rendered').inc(len(outputs))
            if outputs:
                tick_timing = self.stepper.last_timing
                entry = {
                    'tick': plan.tick,
                    'frames': len(outputs),
                    'sorted_slots': tick_timing.sorted_slots,
                    'sort_ms': tick_timing.sort_ms,
                    'shade_ms': tick_timing.shade_ms,
                    'latency_ms': tick_timing.latency_s * 1e3,
                    'host_ms': self._carry_host_ms
                               + (host.host_ms if host else 0.0),
                    'overlap_ms': self._carry_overlap_ms
                                  + (host.overlap_ms if host else 0.0),
                    'kernel_ms': tick_timing.kernel_ms,
                }
                self._carry_host_ms = self._carry_overlap_ms = 0.0
                entry.update(self.stepper.state_metrics())
                self.tick_log.append(entry)
                obs_metrics.publish_tick(self.metrics, entry)
                self.metrics.histogram(
                    'serve.tick_latency_ms',
                    'wall latency of rendered ticks').observe(
                        entry['latency_ms'])
            elif host is not None:
                self._carry_host_ms += host.host_ms
                self._carry_overlap_ms += host.overlap_ms
            self.tick = plan.tick + 1
            return len(outputs)

    def snapshot(self) -> dict:
        """A consistent view of session placement: pending sids, ``(slot,
        sid, admitted_tick)`` for occupied slots, finished sids and the
        tick, all read under the manager lock."""
        with self._lock:
            return {
                'tick': self.tick,
                'pending': tuple(s.sid for s in self.pending),
                'slotted': tuple(
                    (slot, s.sid, s.telemetry.admitted_tick)
                    for slot, s in enumerate(self.slot_session)
                    if s is not None),
                'finished': tuple(s.sid for s in self.finished),
            }

    # -- the serving loop --------------------------------------------------

    def run_tick(self) -> int:
        """One scheduler tick: evict, admit, render every due slot one
        frame (plan -> apply -> dispatch/finish -> observe).  Returns the
        number of frames rendered."""
        with self.tracer.span('tick', tick=self.tick):
            t0 = time.perf_counter()
            plan = self.plan_tick()
            host = HostTiming(host_ms=(time.perf_counter() - t0) * 1e3)
            self.apply_plan(plan)
            outputs = self.stepper.step_finish(
                self.stepper.step_dispatch(plan.cams, plan=plan.sort_plan))
            return self.observe_tick(plan, outputs, host=host)

    def drained(self) -> bool:
        return not self.pending and not self.active_slots()

    def run(self, max_ticks: int = 100_000,
            driver: str = 'sync') -> list[ViewerSession]:
        """Drive ticks until every submitted session has completed."""
        return get_driver(driver, self).run(max_ticks)
