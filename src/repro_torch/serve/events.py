"""The serving host pipeline's event seam: tick plans and the drivers.

The ``SessionManager`` tick decomposes into three operations (see
``repro_torch.serve.session``):

  * ``plan_tick``    — pure host planning: which slots evict, which pending
    sessions admit where, which slots render which cameras, plus the
    stepper's residency and pose-cell sort plan.  It reads host state only
    (numpy, Python objects, the cameras' host poses), so it may run off the
    main thread;
  * ``apply_plan``   — atomic commit of the plan's admissions and evictions;
  * ``observe_tick`` — per-frame telemetry and cursor advance once the
    device outputs land.

Two drivers sequence those operations:

  * ``SyncDriver``     — the virtual-clock driver: it runs them inline, one
    tick at a time, on a tick counter that is the clock, so replaying an
    arrival trace (``repro_torch.serve.traffic``) reproduces the same
    images, cache state and sort cadence;
  * ``ThreadedDriver`` — the real-time driver: a host worker thread plans
    tick ``t+1`` while the main thread finishes tick ``t``.  The plan for
    ``t+1`` is a pure function of the post-dispatch host state plus the
    "active slots advanced one frame" adjustment, so images, cache state
    and sort cadence equal the sync driver's; only wall-clock telemetry
    (``host_ms``/``overlap_ms``) differs.

Worker-thread contract: the worker calls only ``mgr.plan_tick(tick,
advanced=)``, which reads manager state (pending queue, slot sessions,
cursors) and the stepper's host mirrors, never a device tensor.  It is
asked for a plan only after ``step_dispatch`` has returned (every host
mutation of tick ``t`` is done by then), and its plan is collected before
the main thread writes host state again (containment's quarantine, observe,
the next apply), so it always reads quiescent state; the queue pair is the
synchronisation.

On the card the port's ``step_dispatch`` synchronises inside (after the
sorts, and in each round of the cache insert), so the device window that
the worker's planning can hide behind is the short tail that
``step_finish`` waits for.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings
from typing import Optional

from . import faults as serve_faults


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


def _rendering(plan: TickPlan) -> frozenset:
    """The slots whose frame tick ``plan.tick`` renders: the plan's cameras
    less the slots its residency plan stalls (a stalled slot's cursor stays,
    and its frame retries next tick)."""
    stream = getattr(plan.sort_plan, 'stream', None)
    stalled = stream.stalled if stream is not None else frozenset()
    return frozenset(plan.cams) - stalled


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


class ThreadedDriver:
    """Real-time driver: host planning double-buffered against the device
    step.

    Main-thread loop per tick ``t``::

        apply_plan(plan_t)                  # atomic admissions/evictions
        inflight = dispatch_hardened(plan_t)
        cmd_q.put(plan request for t+1)     # the worker plans meanwhile
        outputs = finish_hardened(inflight) # waits for the device
        plan_{t+1} = out_q.get()            # bounded wait
        poison, containment, observe_tick(plan_t, outputs)

    The worker's planning interval is intersected with the tick's device
    window ``[dispatch start, outputs ready]`` to report ``overlap_ms``.

    Hardening (``repro_torch.serve.faults``; every recovery path counts
    ``serve.faults{kind=...}`` / ``serve.degraded_ticks`` through the
    manager):

    * the completion wait is bounded (``mgr.watchdog_s``, else
      ``mgr.default_watchdog_s``): on a worker that dies without posting
      the loop warns, plans the tick inline (degraded), restarts the worker
      on a fresh queue pair and keeps serving;
    * a worker ``plan_tick`` exception is contained: the fault is counted
      and the tick planned inline (a real planner bug re-raises there);
    * when containment drops a poisoned frame or a dispatch is shed, the
      worker's plan (made assuming every rendering slot's cursor advances)
      is dropped and the tick planned inline after ``observe_tick``:
      planning is pure, so the inline plan is what the worker would have
      made from the corrected cursors;
    * at shutdown a worker that outlives ``join(JOIN_TIMEOUT_S)`` is
      reported as a ``RuntimeWarning``, the ``serve.thread_leaks`` counter
      and a ``thread_leak`` trace instant.
    """

    JOIN_TIMEOUT_S = 5.0

    def __init__(self, mgr):
        self.mgr = mgr
        self._cmd_q: Optional[queue.Queue] = None
        self._out_q: Optional[queue.Queue] = None
        self._th: Optional[threading.Thread] = None

    # -- worker lifecycle --------------------------------------------------

    def _start_worker(self) -> None:
        mgr = self.mgr
        cmd_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue()

        def worker():
            inj = mgr.injector
            while True:
                msg = cmd_q.get()
                if msg is None:
                    return
                tick, advanced = msg
                if inj.enabled \
                        and inj.take('worker_death', tick) is not None:
                    # a simulated death: exit without posting.  Counted
                    # here, since only this thread knows the event fired;
                    # the main loop sees a timeout
                    mgr.count_fault('worker_death', tick)
                    return
                t0 = time.perf_counter()
                try:
                    plan = mgr.plan_tick(tick, advanced=advanced)
                    out_q.put(('plan', plan, t0, time.perf_counter()))
                except Exception as exc:  # contained on the main thread
                    out_q.put(('error', exc, t0, time.perf_counter()))

        th = threading.Thread(target=worker, name='serve-host-planner',
                              daemon=True)
        th.start()
        self._cmd_q, self._out_q, self._th = cmd_q, out_q, th

    def _restart_worker(self) -> None:
        """Replace a dead or hung worker.  Fresh queues isolate the old
        one: if it ever wakes, it finds the stop message on its own command
        queue, and a late plan it posts lands on a queue nobody reads."""
        if self._cmd_q is not None:
            self._cmd_q.put(None)
        self._start_worker()

    def _stop_worker(self) -> None:
        mgr = self.mgr
        if self._cmd_q is not None:
            self._cmd_q.put(None)
        if self._th is not None:
            self._th.join(timeout=self.JOIN_TIMEOUT_S)
            if self._th.is_alive():
                mgr.metrics.counter(
                    'serve.thread_leaks',
                    'planner threads alive past their join deadline').inc()
                mgr.tracer.instant('thread_leak', thread=self._th.name)
                warnings.warn(
                    f'{self._th.name} thread did not exit within '
                    f'{self.JOIN_TIMEOUT_S}s; daemon thread leaked',
                    RuntimeWarning, stacklevel=2)
        self._cmd_q = self._out_q = self._th = None

    # -- plan collection ---------------------------------------------------

    def _collect_plan(self, want_tick: int):
        """Bounded wait for the worker's plan for ``want_tick``.  Returns
        ``(plan, p0, p1)``, or ``(None, 0, 0)`` when the tick must be
        planned inline: the worker died (timeout: warn and restart) or its
        ``plan_tick`` raised (fault counted; a real planner bug re-raises
        from the inline replan)."""
        mgr = self.mgr
        deadline = mgr.watchdog_s if mgr.watchdog_s is not None \
            else mgr.default_watchdog_s
        try:
            kind, payload, p0, p1 = self._out_q.get(timeout=deadline)
        except queue.Empty:
            mgr.metrics.counter(
                'serve.watchdog',
                'finish/plan watchdog deadline expiries').inc()
            mgr.tracer.instant('watchdog', what='planner', tick=want_tick)
            warnings.warn(
                f'serve watchdog: no plan for tick {want_tick} within '
                f'{deadline}s (worker dead?); replanning inline and '
                f'restarting the worker', RuntimeWarning, stacklevel=2)
            self._restart_worker()
            return None, 0.0, 0.0
        if kind == 'error':
            if not isinstance(payload, serve_faults.InjectedFault):
                # a real planner error: contained, but never silent
                warnings.warn(f'planner worker raised {payload!r}; '
                              f'replanning tick {want_tick} inline',
                              RuntimeWarning, stacklevel=2)
            mgr.count_fault('plan_exc', want_tick)
            return None, 0.0, 0.0
        return payload, p0, p1

    # -- the loop ----------------------------------------------------------

    def run(self, max_ticks: int = 100_000):
        mgr = self.mgr
        self._start_worker()

        def inline_plan():
            t0 = time.perf_counter()
            plan = mgr.plan_tick_hardened()
            return plan, HostTiming(
                host_ms=(time.perf_counter() - t0) * 1e3)

        try:
            plan, host0 = inline_plan()
            while True:
                # the tick span lies on the 'host' track, the worker's
                # plan_tick span for t+1 on 'host-worker' and the
                # stepper's shade window on 'device'
                with mgr.tracer.span('tick', tick=plan.tick):
                    mgr.apply_plan(plan)
                    if mgr.drained():
                        break
                    t_disp = time.perf_counter()
                    inflight, ok = mgr.dispatch_hardened(plan.cams, plan)
                    if not ok:
                        # a shed tick: nothing in flight and the worker
                        # was never asked; observe the empty tick (cursors
                        # stay, frames retry) and plan inline
                        mgr.observe_tick(plan, {}, host=host0)
                        mgr.maybe_checkpoint()
                        plan, host0 = inline_plan()
                        continue
                    # every host mutation of tick t is done: the worker
                    # plans t+1 while the device finishes t, with the
                    # cursors of the slots that render t one frame on
                    self._cmd_q.put((plan.tick + 1, _rendering(plan)))
                    outputs = mgr.finish_hardened(inflight, plan.tick)
                    t_ready = time.perf_counter()
                    # collected before containment, whose quarantine
                    # writes the stepper state the worker reads
                    nxt, p0, p1 = self._collect_plan(plan.tick + 1)
                    outputs = mgr.poison_outputs(outputs, plan.tick)
                    outputs, poisoned = mgr.contain_outputs(outputs,
                                                            plan.tick)
                    mgr.observe_tick(plan, outputs, host=host0)
                    mgr.maybe_checkpoint()
                    if nxt is None or poisoned:
                        # degraded: the worker's plan is missing, or it
                        # assumed a cursor advance that containment rolled
                        # back; replan inline on the post-observe state
                        mgr.count_degraded(plan.tick + 1)
                        plan, host0 = inline_plan()
                    else:
                        overlap_s = max(0.0, min(p1, t_ready)
                                        - max(p0, t_disp))
                        host0 = HostTiming(host_ms=(p1 - p0) * 1e3,
                                           overlap_ms=overlap_s * 1e3)
                        plan = nxt
                if mgr.tick >= max_ticks:
                    raise RuntimeError('serve loop did not drain')
        finally:
            self._stop_worker()
        return mgr.finished


DRIVERS = {'sync': SyncDriver, 'threaded': ThreadedDriver}


def get_driver(name: str, mgr):
    try:
        return DRIVERS[name](mgr)
    except KeyError:
        raise ValueError(f'unknown serve driver {name!r} '
                         f'(expected one of {sorted(DRIVERS)})') from None
