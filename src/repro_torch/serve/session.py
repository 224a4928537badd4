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
(atomic commit of admissions, evictions and lane swaps under the manager
lock) and ``observe_tick`` (telemetry and cursor advance).  ``run_tick``
composes them inline with the hardened device leg (``step_hardened``:
dispatch with retry, finish under a watchdog, poison and containment, each
a no-op under the NULL fault injector); ``run(driver=...)`` hands the
sequencing to a driver (``repro_torch.serve.events``: the virtual-clock
``'sync'`` or the ``'threaded'`` one, whose worker plans tick t+1 while the
device finishes tick t) until every session has finished, checkpointing at
tick boundaries when ``enable_checkpoints`` asked for it.

**Frame pacing**: a session with ``pace = p`` consumes one frame every
``p`` ticks counted from its admission; its slot stays occupied on the
ticks between.

**Slot oversubscription** (``oversubscribe=True``, shared-scene steppers
only): paced sessions whose render ticks can never collide share one
physical slot.  Admission requires ``(tick - admitted_tick_r) % gcd(pace_r,
pace_new) != 0`` against every resident of the slot, which holds the
newcomer to a disjoint residue class for good.  The lane's occupant
renders; co-residents are parked in the stepper's stash (``stash_lane``)
and swapped in on their due ticks (``TickPlan.switches``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
import warnings
from collections import deque
from typing import Optional

import torch

from ..core.camera import Camera
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import faults as serve_faults
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

    def current_cam(self) -> Camera:
        return self.cams[self.cursor]


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
    ``injector`` is a ``faults.FaultInjector`` (``faults.NULL``, no faults,
    by default); ``watchdog_s`` arms a deadline around each tick's finish
    (armed too, at ``default_watchdog_s``, when faults are injected).
    """

    #: dispatch retry policy for injected device failures
    max_retries = 3
    backoff_s = 0.002
    #: the finish watchdog's deadline when faults are injected and
    #: ``watchdog_s`` is unset (s)
    default_watchdog_s = 30.0

    def __init__(self, stepper, slots: int, tracer=None,
                 metrics: Optional[obs_metrics.Registry] = None,
                 injector=None, watchdog_s: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 oversubscribe: bool = False):
        self.stepper = stepper
        self.slots = slots
        # one tracer and registry for the manager and its stepper
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.metrics = metrics if metrics is not None else \
            obs_metrics.Registry()
        stepper.tracer = self.tracer
        stepper.metrics = self.metrics
        self.injector = injector if injector is not None else \
            serve_faults.NULL
        self.watchdog_s = watchdog_s
        self.max_pending = max_pending
        self.shed: list[ViewerSession] = []
        # crash-consistent checkpointing (enable_checkpoints)
        self._ckpt = None
        self._ckpt_every = 0
        self._ckpt_extra: Optional[dict] = None
        self.viewers_per_scene = getattr(stepper, 'viewers_per_scene', 1)
        self.num_scenes = max(1, slots // self.viewers_per_scene)
        # oversubscription needs the stepper's lane stash and a shared scene
        # block: a private scene interleaving two viewers would thrash the
        # cache its block keeps warm
        self.oversubscribe = bool(
            oversubscribe and hasattr(stepper, 'stash_lane')
            and self.viewers_per_scene > 1)
        if oversubscribe and not self.oversubscribe:
            raise ValueError('oversubscribe requires a shared-scene stepper '
                             '(viewers_per_scene > 1) with a lane stash')
        # stashed co-resident sessions per slot (the lane's occupant stays
        # in slot_session)
        self._coresidents: dict[int, list[ViewerSession]] = {}
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

    def resident_count(self) -> int:
        """Sessions holding serving state: lane occupants plus stashed
        co-residents."""
        return (sum(1 for s in self.slot_session if s is not None)
                + sum(len(v) for v in self._coresidents.values()))

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

    def admit_ready(self) -> list[int]:
        """Admit arrived pending sessions into free slots now, outside the
        tick plan: FIFO, or, with scene blocks, FIFO per admissible session
        (a session whose block is full waits without blocking later
        sessions bound for other scenes).  Returns the slots filled."""
        with self._lock:
            admitted = []
            if self.viewers_per_scene == 1:
                for slot in self.free_slots():
                    if (not self.pending
                            or self.pending[0].arrival_tick > self.tick):
                        break
                    self._admit_into(slot, self.pending.popleft())
                    admitted.append(slot)
                return admitted
            waiting = deque()
            while self.pending:
                sess = self.pending.popleft()
                free = [i for i in self._scene_block(sess.scene_id)
                        if self.slot_session[i] is None]
                if sess.arrival_tick <= self.tick and free:
                    self._admit_into(free[0], sess)
                    admitted.append(free[0])
                else:
                    waiting.append(sess)
            self.pending = waiting
            return admitted

    def vacate(self, slot: int) -> ViewerSession:
        """Remove the session occupying ``slot`` without marking it finished
        (it continues elsewhere).  The slot's device state is left as it
        is; the next admit into it cold-starts it."""
        with self._lock:
            sess = self.slot_session[slot]
            if sess is None:
                raise RuntimeError(f'vacate: slot {slot} is empty')
            if self._coresidents.get(slot):
                raise RuntimeError(f'vacate: slot {slot} has stashed '
                                   'co-residents (drain them first)')
            self.slot_session[slot] = None
            self._release_slot(slot)
            return sess

    def place(self, slot: int, sess: ViewerSession,
              payload: Optional[dict] = None,
              admitted_tick: Optional[int] = None) -> None:
        """Place a session directly into a free slot, bypassing the queue.
        With ``payload`` the stepper restores an extracted viewer lane
        (``BatchedStepper.extract_viewer``), else the slot is cold-admitted.
        ``admitted_tick`` keeps a paced session's cadence across the move
        (the current tick by default)."""
        with self._lock:
            occupant = self.slot_session[slot]
            if occupant is not None:
                raise RuntimeError(f'place: slot {slot} occupied by sid '
                                   f'{occupant.sid}')
            sess.telemetry.admitted_tick = (
                self.tick if admitted_tick is None else int(admitted_tick))
            self.slot_session[slot] = sess
            if payload is None:
                self.stepper.admit(slot)
            else:
                self.stepper.restore_viewer(slot, payload)

    def evict_finished(self) -> list[int]:
        """Evict finished lane occupants.  A slot with stashed co-residents
        is not freed: the co-resident admitted earliest is promoted into the
        lane (a stashed session never renders, so it is never done)."""
        with self._lock:
            evicted = []
            for slot, sess in enumerate(self.slot_session):
                if sess is None or not sess.done:
                    continue
                sess.telemetry.finished_tick = self.tick
                self.finished.append(sess)
                co = self._coresidents.get(slot)
                if co:
                    succ = min(co, key=lambda c: c.telemetry.admitted_tick)
                    co.remove(succ)
                    self.slot_session[slot] = succ
                    self.stepper.unstash_lane(slot, str(succ.sid))
                else:
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

    def plan_tick(self, tick: Optional[int] = None,
                  advanced=()) -> TickPlan:
        """The next tick's host decisions, computed without mutating
        anything: evictions, admissions, lane swaps, the cameras of the
        slots that render, and the stepper's pose-cell sort plan against
        the post-admission active set.  ``advanced`` names the slots of a
        tick still in flight, whose occupants count as one frame further
        along (empty on the sync driver).  An injected ``plan_exc`` fault
        raises before any planning work."""
        tick = self.tick if tick is None else tick
        if self.injector.enabled \
                and self.injector.take('plan_exc', tick) is not None:
            raise serve_faults.InjectedPlanError(
                f'injected plan_tick fault at tick {tick}')
        with self.tracer.span('plan_tick', tick=tick):
            return self._plan_tick(tick, advanced)

    def _plan_tick(self, tick: int, advanced=()) -> TickPlan:
        adv = frozenset(advanced)

        def cursor_of(slot: int, sess: ViewerSession) -> int:
            # an in-flight frame belongs to the lane's occupant; stashed
            # co-residents never render in flight
            return sess.cursor + (1 if slot in adv else 0)

        cor_slots = {slot for slot, lst in self._coresidents.items() if lst}
        evict = tuple(
            slot for slot, sess in enumerate(self.slot_session)
            if sess is not None and slot not in cor_slots
            and cursor_of(slot, sess) >= len(sess.cams))
        free = sorted(set(self.free_slots()) | set(evict))
        placements = self._plan_admissions(free, tick)
        admit = tuple((slot, sess.sid) for slot, sess in placements)
        admitted_slots = {slot for slot, _ in admit}

        # Oversubscribed lanes: at most one resident (occupant or stashed
        # co-resident) is due per tick, by the admission-time residue check.
        # A due co-resident swaps in; a finished occupant retires into the
        # swap (its lane needs no stashing).
        cams: dict[int, Camera] = {}
        switches = []
        for slot in sorted(cor_slots):
            sess = self.slot_session[slot]
            occupant_done = cursor_of(slot, sess) >= len(sess.cams)
            due_co = [c for c in self._coresidents[slot] if not c.done
                      and (tick - c.telemetry.admitted_tick) % c.pace == 0]
            if due_co:
                inc = due_co[0]
                switches.append((slot, inc.sid))
                cams[slot] = inc.cams[inc.cursor]
            elif occupant_done:
                inc = min(self._coresidents[slot],
                          key=lambda c: c.telemetry.admitted_tick)
                switches.append((slot, inc.sid))
            elif self._frame_due(sess, tick):
                cams[slot] = sess.cams[cursor_of(slot, sess)]

        for slot, sess in enumerate(self.slot_session):
            if sess is None or slot in evict or slot in admitted_slots \
                    or slot in cor_slots:
                continue
            if self._frame_due(sess, tick):
                cams[slot] = sess.cams[cursor_of(slot, sess)]
        for slot, sess in placements:
            cams[slot] = sess.cams[0]

        sort_plan = None
        plan_step = getattr(self.stepper, 'plan_step', None)
        if plan_step is not None:
            if switches:
                sort_plan = plan_step(
                    cams, pending_admits=admitted_slots,
                    lane_swaps={slot: str(sid) for slot, sid in switches})
            else:
                sort_plan = plan_step(cams, pending_admits=admitted_slots)
        return TickPlan(tick=tick, evict=evict, admit=admit, cams=cams,
                        sort_plan=sort_plan, switches=tuple(switches))

    def _plan_admissions(self, free: list, tick: int) -> list:
        """``(slot, session)`` placements over a hypothetical free-slot
        list, in pending-queue order, without popping anything: FIFO over
        the free slots, or, with scene blocks, FIFO per admissible session
        (a session whose block is full waits without blocking later
        sessions bound for other scenes).  With oversubscription a paced
        session whose block is full may be co-placed onto an occupied slot
        whose residents render on residue-disjoint ticks."""
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
        co_placed: set[int] = set()
        for sess in pending:
            if sess.arrival_tick > tick:
                continue
            block = [i for i in self._scene_block(sess.scene_id)
                     if i in remaining]
            if block:
                placements.append((block[0], sess))
                remaining.discard(block[0])
                continue
            if not self.oversubscribe or sess.pace < 2:
                continue
            # The newcomer renders on ticks = tick (mod pace), resident r on
            # ticks = admitted_r (mod pace_r): they never collide iff tick
            # != admitted_r (mod gcd(pace_r, pace)), a relation that holds
            # for good.  One co-placement per slot per tick (two same-tick
            # admits would share a residue).
            for slot in self._scene_block(sess.scene_id):
                occ = self.slot_session[slot]
                if occ is None or slot in co_placed or slot in remaining:
                    continue
                residents = [occ] + self._coresidents.get(slot, [])
                if any(r.pace < 2 for r in residents):
                    continue
                if all((tick - r.telemetry.admitted_tick)
                       % math.gcd(r.pace, sess.pace) != 0
                       for r in residents):
                    placements.append((slot, sess))
                    co_placed.add(slot)
                    break
        return placements

    def apply_plan(self, plan: TickPlan) -> None:
        """Commit a plan's evictions, lane swaps and admissions atomically:
        a session is either fully pending or fully admitted (placed,
        stepper slot reset, ``admitted_tick`` stamped) in any concurrent
        view."""
        with self.tracer.span('apply_plan', tick=plan.tick,
                              admits=len(plan.admit),
                              evicts=len(plan.evict)), self._lock:
            if plan.tick != self.tick:
                raise RuntimeError(f'stale plan: tick {plan.tick} applied at '
                                   f'manager tick {self.tick}')
            retired = 0
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
            for slot, sid in plan.switches:
                sess = self.slot_session[slot]
                co = self._coresidents.get(slot, [])
                inc = next((c for c in co if c.sid == sid), None)
                if inc is None:
                    raise RuntimeError(f'planned switch-in {sid} is not a '
                                       f'co-resident of slot {slot}')
                co.remove(inc)
                if sess.done:
                    # the outgoing occupant retires through the swap
                    sess.telemetry.finished_tick = plan.tick
                    self.finished.append(sess)
                    retired += 1
                    self.tracer.instant('evict', slot=slot, sid=sess.sid,
                                        tick=plan.tick)
                else:
                    self.stepper.stash_lane(slot, str(sess.sid))
                    co.append(sess)
                self.slot_session[slot] = inc
                self.stepper.unstash_lane(slot, str(inc.sid))
                self.tracer.instant('switch', slot=slot, sid=inc.sid,
                                    tick=plan.tick)
            self.metrics.counter(
                'serve.evicted', 'sessions leaving their slot').inc(
                    len(plan.evict) + retired)
            for slot, sid in plan.admit:
                occupant = self.slot_session[slot]
                sess = next((s for s in self.pending if s.sid == sid), None)
                if sess is None:
                    raise RuntimeError(f'planned session {sid} not pending')
                if occupant is not None:
                    if not self.oversubscribe:
                        raise RuntimeError(f'plan admits into occupied slot '
                                           f'{slot}')
                    # co-placement: park the lane's occupant and cold-start
                    # the newcomer in the lane (the scene cache persists)
                    self.stepper.stash_lane(slot, str(occupant.sid))
                    self._coresidents.setdefault(slot, []).append(occupant)
                    self.metrics.counter(
                        'serve.oversubscribed',
                        'sessions co-placed onto an occupied slot').inc()
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
            # resident slot-ticks that rendered nothing (pace gaps, done
            # sessions awaiting eviction, stashed co-residents)
            idle = self.resident_count() - len(outputs)
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

    # -- fault handling ----------------------------------------------------
    #
    # Under the NULL injector each helper reduces to the plain path: one
    # attribute test, no wrapping, no device sync.

    def count_fault(self, kind: str, tick: int) -> None:
        """One observed fault event."""
        self.metrics.counter('serve.faults',
                             'fault events observed by the host loop',
                             kind=kind).inc()
        self.tracer.instant('fault', kind=kind, tick=tick)

    def count_degraded(self, tick: int) -> None:
        """One tick served in degraded mode (inline replan, shed
        dispatch)."""
        self.metrics.counter(
            'serve.degraded_ticks',
            'ticks served in degraded (inline/shed) mode').inc()
        self.tracer.instant('degraded', tick=tick)

    def plan_tick_hardened(self, tick: Optional[int] = None,
                           advanced=()) -> TickPlan:
        """``plan_tick`` surviving an injected planner exception: the fault
        fires before any planning work and planning is pure, so the retry
        sees the same inputs."""
        try:
            return self.plan_tick(tick, advanced)
        except serve_faults.InjectedPlanError:
            t = self.tick if tick is None else tick
            self.count_fault('plan_exc', t)
            self.count_degraded(t)
            return self.plan_tick(tick, advanced)

    def poison_outputs(self, outputs: dict, tick: int) -> dict:
        """Apply a pending ``nan_poison`` event: one slot's finished image
        is replaced with NaNs.  Detection is ``contain_outputs``'s own
        finite scan, which never reads the injector's choice.  With no
        output this tick the event stays armed."""
        inj = self.injector
        if not inj.enabled or not outputs \
                or not inj.peek('nan_poison', tick):
            return outputs
        ev = inj.take('nan_poison', tick)
        slot = inj.poison_slot(ev, sorted(outputs))
        self.count_fault('nan_poison', tick)
        self.tracer.instant('poison', slot=slot, tick=tick)
        img, stats, timing = outputs[slot]
        outputs = dict(outputs)
        outputs[slot] = (torch.full_like(img, float('nan')), stats, timing)
        return outputs

    def dispatch_hardened(self, cams: dict, plan: TickPlan):
        """``step_dispatch`` with retry and backoff.  Injected dispatch
        faults fire before the dispatch changes any state, so retrying is
        safe.  A transient event costs ``count`` backed-off retries, then
        the dispatch goes through; a persistent one exhausts the retry
        budget and sheds the tick: returns ``(None, False)``, no cursor
        advances, and every due frame is replanned next tick."""
        inj = self.injector
        dispatch = self.stepper.step_dispatch
        if not inj.enabled:
            return dispatch(cams, plan=plan.sort_plan), True
        retries = self.metrics.counter('serve.retries',
                                       'dispatch retry attempts')
        ev = inj.take('dispatch_persistent', plan.tick)
        if ev is not None:
            self.count_fault('dispatch_persistent', plan.tick)
            with self.tracer.span('dispatch_retry', tick=plan.tick,
                                  outcome='shed'):
                for attempt in range(self.max_retries):
                    retries.inc()
                    time.sleep(self.backoff_s * (2 ** attempt))
            self.count_degraded(plan.tick)
            self.tracer.instant('tick_shed', tick=plan.tick,
                                frames=len(cams))
            return None, False
        ev = inj.take('dispatch_transient', plan.tick)
        if ev is not None:
            self.count_fault('dispatch_transient', plan.tick)
            with self.tracer.span('dispatch_retry', tick=plan.tick,
                                  outcome='recovered', failures=ev.count):
                for attempt in range(min(ev.count, self.max_retries)):
                    retries.inc()
                    time.sleep(self.backoff_s * (2 ** attempt))
        return dispatch(cams, plan=plan.sort_plan), True

    def finish_hardened(self, inflight, tick: int) -> dict:
        """``step_finish`` under a stall watchdog, armed only when
        ``watchdog_s`` is set or faults are injected.  An injected ``stall``
        delays completion inside the window; an expiry warns and counts
        ``serve.watchdog`` but keeps waiting (abandoning a tick in flight
        would leave its state half written)."""
        inj = self.injector
        deadline = self.watchdog_s
        if deadline is None and inj.enabled:
            deadline = self.default_watchdog_s
        timer = None
        if deadline is not None:
            def expired():
                self.metrics.counter(
                    'serve.watchdog',
                    'finish/plan watchdog deadline expiries').inc()
                self.tracer.instant('watchdog', what='step_finish',
                                    tick=tick)
                warnings.warn(
                    f'serve watchdog: step_finish exceeded {deadline}s at '
                    f'tick {tick} (device stalled?)', RuntimeWarning,
                    stacklevel=2)
            timer = threading.Timer(deadline, expired)
            timer.daemon = True
            timer.start()
        try:
            ev = inj.take('stall', tick) if inj.enabled else None
            if ev is not None:
                self.count_fault('stall', tick)
                with self.tracer.span('device_stall', tick=tick,
                                      delay_s=ev.delay_s):
                    time.sleep(ev.delay_s)
            return self.stepper.step_finish(inflight)
        finally:
            if timer is not None:
                timer.cancel()

    def contain_outputs(self, outputs: dict, tick: int) -> tuple:
        """Per-viewer containment: an output whose image is not finite is
        dropped (its cursor does not advance, so the frame retries) and its
        slot quarantined (``stepper.quarantine``).  Returns
        ``(clean_outputs, poisoned_slots)``.  Scans only while faults are
        injected: a healthy tick is not synced and scanned."""
        if not self.injector.enabled or not outputs:
            return outputs, ()
        poisoned = tuple(
            slot for slot, (img, _stats, _timing) in outputs.items()
            if not bool(torch.isfinite(img).all()))
        if not poisoned:
            return outputs, ()
        for slot in poisoned:
            self.tracer.instant('quarantine', slot=slot, tick=tick)
            self.stepper.quarantine(slot)
        self.metrics.counter(
            'serve.quarantined',
            'poisoned frames dropped and their slots reset').inc(
                len(poisoned))
        clean = {s: o for s, o in outputs.items() if s not in poisoned}
        return clean, poisoned

    def step_hardened(self, plan: TickPlan) -> tuple:
        """The hardened device leg of one tick: dispatch with retry, finish
        under the watchdog, poison, containment.  Returns ``(outputs,
        poisoned_slots)``."""
        inflight, ok = self.dispatch_hardened(plan.cams, plan)
        if not ok:
            return {}, ()
        outputs = self.finish_hardened(inflight, plan.tick)
        outputs = self.poison_outputs(outputs, plan.tick)
        return self.contain_outputs(outputs, plan.tick)

    # -- crash-consistent checkpoint/restore -------------------------------

    def enable_checkpoints(self, manager, every: int,
                           extra: Optional[dict] = None) -> None:
        """Snapshot the serving state through a ``repro_torch.checkpoint``
        ``CheckpointManager`` every ``every`` ticks (the driver calls
        ``maybe_checkpoint`` at each tick boundary).  ``extra`` is JSON-able
        context stored beside it (e.g. the traffic trace)."""
        self._ckpt = manager
        self._ckpt_every = int(every)
        self._ckpt_extra = extra

    def maybe_checkpoint(self) -> bool:
        if self._ckpt is None or self._ckpt_every <= 0:
            return False
        if self.tick == 0 or self.tick % self._ckpt_every:
            return False
        self.checkpoint_now()
        return True

    def checkpoint_now(self) -> None:
        """Snapshot at the current tick boundary (no tick in flight).  The
        stepper's state is taken without a device copy:
        ``CheckpointManager.save`` copies it to host memory before
        returning, so the next tick may write the live state in place at
        once."""
        with self.tracer.span('checkpoint', tick=self.tick):
            arrays, stepper_meta = self.stepper.state_dict(copy=False)
            with self._lock:
                meta = {
                    'tick': self.tick,
                    'stepper': stepper_meta,
                    'slots': [
                        None if s is None else {
                            'sid': s.sid, 'cursor': s.cursor,
                            'admitted_tick': s.telemetry.admitted_tick}
                        for s in self.slot_session],
                    'coresidents': {
                        str(slot): [{'sid': c.sid, 'cursor': c.cursor,
                                     'admitted_tick':
                                         c.telemetry.admitted_tick}
                                    for c in lst]
                        for slot, lst in self._coresidents.items() if lst},
                    'pending': [s.sid for s in self.pending],
                    'finished': [s.sid for s in self.finished],
                    'shed': [s.sid for s in self.shed],
                }
            if self._ckpt_extra:
                meta['extra'] = self._ckpt_extra
            self._ckpt.save(arrays, step=self.tick, extra=meta)

    def restore_serving(self, ckpt, sessions,
                        max_step: Optional[int] = None) -> Optional[int]:
        """Restore the newest loadable checkpoint into this manager.

        ``sessions`` must be the sessions (sids and trajectories) the
        checkpointed run was built from: the snapshot stores cursors and
        placement, not cameras.  Stepper state, scheduler bookkeeping,
        placement, the pending order and the tick restore, and the run
        continues bit for bit as the uninterrupted one would.  Returns the
        restored step, or None when no checkpoint loads.  ``max_step``
        caps the step restored."""
        out = self._restore_arrays(ckpt, max_step=max_step)
        if out is None:
            return None
        arrays, step, meta = out
        self.stepper.load_state(arrays, meta['stepper'])
        by_sid = {s.sid: s for s in sessions}
        with self._lock:
            self.tick = int(meta['tick'])
            self.slot_session = []
            for m in meta['slots']:
                if m is None:
                    self.slot_session.append(None)
                    continue
                sess = by_sid.pop(m['sid'])
                sess.cursor = int(m['cursor'])
                sess.telemetry.admitted_tick = int(m['admitted_tick'])
                self.slot_session.append(sess)
            self._coresidents = {}
            for slot_s, lst in meta.get('coresidents', {}).items():
                co = []
                for m in lst:
                    sess = by_sid.pop(m['sid'])
                    sess.cursor = int(m['cursor'])
                    sess.telemetry.admitted_tick = int(m['admitted_tick'])
                    co.append(sess)
                self._coresidents[int(slot_s)] = co
            self.finished = []
            for sid in meta['finished']:
                sess = by_sid.pop(sid)
                sess.cursor = len(sess.cams)
                self.finished.append(sess)
            self.shed = [by_sid.pop(sid) for sid in meta.get('shed', ())]
            self.pending = deque(by_sid.pop(sid)
                                 for sid in meta['pending'])
        self.tracer.instant('restore', tick=self.tick, step=step)
        self.metrics.counter('serve.restores',
                             'runs resumed from a checkpoint').inc()
        return int(step)

    def _restore_arrays(self, ckpt, max_step=None,
                        device=None) -> Optional[tuple]:
        """The newest loadable checkpoint as ``(arrays, step, meta)``, with
        the shape template built per step from the manifest's stepper
        geometry (a snapshot's pool capacity and stashed lanes are part of
        it).  Steppers without ``state_template`` restore into their own
        ``state_dict`` through ``restore_latest``.  An unreadable snapshot
        falls back one step.  ``device`` puts the tensors there instead of
        on the stepper's device (the fleet reads a lost device's snapshot
        into host memory)."""
        from ..checkpoint.manager import load_checkpoint
        state_template = getattr(self.stepper, 'state_template', None)
        if state_template is None:
            if max_step is not None or device is not None:
                raise ValueError('max_step and device need the '
                                 'manifest-template restore path')
            template, _ = self.stepper.state_dict(copy=False)
            return ckpt.restore_latest(template)
        ckpt.wait()
        steps = [s for s in ckpt.all_steps()
                 if max_step is None or s <= max_step]
        for step in reversed(steps):
            try:
                extra = ckpt.manifest_extra(step)
                if extra is None:
                    raise ValueError('manifest unreadable')
                template = state_template(extra.get('stepper', {}))
                arrays, meta = load_checkpoint(ckpt.dir, template, step=step,
                                               device=device)
                return arrays, step, meta
            except Exception as e:   # corrupt / partial: fall back one step
                ckpt.metrics.counter(
                    'ckpt.restore_fallback',
                    'checkpoints skipped as unreadable at restore').inc()
                warnings.warn(f'checkpoint step {step} unreadable ({e}); '
                              'falling back to previous',
                              RuntimeWarning, stacklevel=2)
        return None

    # -- the serving loop --------------------------------------------------

    def run_tick(self) -> int:
        """One scheduler tick: evict, admit, swap lanes, render every due
        slot one frame (plan -> apply -> hardened step -> observe).
        Returns the number of frames rendered."""
        with self.tracer.span('tick', tick=self.tick):
            t0 = time.perf_counter()
            plan = self.plan_tick_hardened()
            host = HostTiming(host_ms=(time.perf_counter() - t0) * 1e3)
            self.apply_plan(plan)
            outputs, _poisoned = self.step_hardened(plan)
            return self.observe_tick(plan, outputs, host=host)

    def drained(self) -> bool:
        return not self.pending and not self.active_slots()

    def run(self, max_ticks: int = 100_000,
            driver: str = 'sync') -> list[ViewerSession]:
        """Drive ticks until every submitted session has completed.

        ``driver='sync'`` is the virtual-clock host loop (deterministic,
        bit-identical replay); ``driver='threaded'`` double-buffers host
        planning against the device step (``repro_torch.serve.events``).
        """
        return get_driver(driver, self).run(max_ticks)
