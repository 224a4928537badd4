"""Elastic multi-device serving fleet: scene-sharded workers, live session
migration, and device-loss recovery.

One host worker per device (``launch.mesh.serve_devices``: one card each
where there are enough, several workers on one card where there are not),
each a full single-device serving stack: a ``BatchedStepper`` whose tensors
live on that device and a ``SessionManager`` driving the plan/apply/observe
seam (``repro_torch.serve.events``).  Each worker's leg runs under
``torch.cuda.device`` of its card and on that card's current stream.  On
top sits a shared admission queue and a deterministic placement layer:

  * ``plan_route``      — FIFO routing of arrived sessions onto the
    least-loaded alive device (sticky per scene when viewers share scene
    caches), pure Python like ``plan_tick``;
  * ``plan_rebalance``  — greedy max->min moves of *queued* sessions until
    the load spread is within ``slack``; deterministic, a no-op when
    already balanced, never targets a dead device;
  * ``plan_shrink``     — device-loss placement: the lost device's slotted
    viewers map onto survivors' free slots **at the same slot index**
    wherever possible (``aligned``, see below), the rest ``spill`` back to
    the admission queue.

**Lockstep clock.** Every alive worker runs exactly one manager tick per
fleet tick, and idle ticks advance the stepper's ``global_tick`` too, so
all steppers share one sort-cadence clock (``global_tick == fleet tick``).
That invariant is what makes cross-device moves exact: a viewer restored
at the same slot index on a stepper at the same ``global_tick`` sees the
same cadence residue, the same pool-freshness windows and the same lane
state, so every integer of its continuation (hits, sorted flags, the sort
log, cache tags/age/clock) equals never having moved.  Its images are
shaded in one batch with other slots than before the move; the port's
shade reads no other slot's values for a slot's pixels, so they are
bit-identical too, on the plain path (``tests/test_torch_fleet.py``) and
on the kernel path (``chip_smoke.py``'s fleet phase).  The JAX package's
CPU backend couples the slots of one tick in the last float bits (up to
1.2e-7), so there only the integers hold exactly.

**Drivers.** ``SyncFleetDriver`` is the virtual N-device oracle: workers
tick sequentially in device order on a pure tick counter.
``ThreadedFleetDriver`` runs one persistent thread per worker (devices
crunch their ticks concurrently and meet at a barrier at the tick
boundary).  Workers touch disjoint state and run the same ``run_tick``
code, and all fleet-level decisions (routing, loss handling) happen on the
main thread between barriers, so the threaded fleet makes the sync
oracle's decisions and renders its images bit for bit.  Workers on one
card share its current stream, so their device work runs one after
another.  Per-worker wall times feed a
``repro_torch.runtime.straggler.StragglerDetector``;
``exclude_stragglers=True`` turns a persistent straggler into a
``lose_device`` shrink at the tick boundary (wall-clock driven, so it is
off by default to keep runs replayable).

**Live migration** (``FleetManager.migrate``) moves one viewer between
devices at a tick boundary via ``BatchedStepper.extract_viewer`` /
``restore_viewer`` payloads: the viewer's private lane and camera, plus
its scene block (cache, pool entries and their bookkeeping) when the move
is slot-aligned.  Unaligned moves restore cold and re-sort on admission,
so the viewer observes at most one sort window of sharing staleness, the
bound every freshly admitted viewer already lives under.

**Device loss.** A ``device_loss`` fault event (``serve.faults``) or a
straggler exclusion marks a device dead at a tick boundary.  With
checkpointing enabled (all workers snapshot at the same tick multiples, so
the per-device checkpoints form one crash-consistent fleet snapshot)
recovery is a whole-fleet rollback:

  1. every survivor restores its own checkpoint;
  2. the victim's checkpoint is read into host memory; its slotted viewers
     are placed onto survivors by ``plan_shrink``: aligned ones restore
     their exact lane, spilled ones re-queue with their checkpoint cursor;
  3. per-session telemetry rolls back to the restored cursors
     (``SessionTelemetry.rollback``) so replayed frames are not counted
     twice; delivery is at-least-once;
  4. anything admitted after the snapshot re-queues from the start.

Without checkpoints the recovery is cold: host-side cursors are
crash-consistent in-process, so victims re-queue at their current frame
and re-admit cold on survivors, with no viewer dropped either way.  While
capacity is degraded the bounded fleet admission queue (``max_pending``)
sheds *new* load instead of collapsing: accepted viewers always drain.

Fault scope: the fleet consumes only ``device_loss`` from its injector;
per-worker host-loop faults (plan_exc, nan_poison, ...) belong to the
single-device drivers and keep their seams there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import warnings
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.camera import camera_at, camera_from_arrays, camera_to
from ..core.gaussians import FIELDS, GaussianScene
from ..core.pipeline import ViewerPrivate
from ..core.radiance_cache import CacheState
from ..launch.mesh import serve_devices
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime.straggler import StragglerDetector
from . import faults as serve_faults
from . import telemetry as serve_telemetry
from .session import SessionManager, ViewerSession
from .stepper import _CACHE_FIELDS, BatchedStepper, _entry_from


# -- pure placement planners (Python only, no device state) ------------------

def plan_route(pending, loads, alive, scene_home=None):
    """Route arrived sessions onto devices: ``((sid, device), ...)``.

    ``pending`` is ``((sid, scene_id), ...)`` in FIFO order; ``loads`` maps
    device -> current load (active + queued); ``alive`` is the live device
    set.  A scene already homed on an alive device keeps attracting its
    viewers (``scene_home``: scene_id -> device; cache sharing only pays
    on-device); everything else goes to the least-loaded alive device,
    lowest id breaking ties.  Pure and deterministic: same inputs, same
    routing, on any host."""
    alive_l = sorted(alive)
    if not alive_l:
        raise ValueError('plan_route: no alive devices')
    loads = {d: int(loads.get(d, 0)) for d in alive_l}
    out = []
    for sid, scene_id in pending:
        dev = None
        if scene_home:
            home = scene_home.get(scene_id)
            if home in loads:
                dev = home
        if dev is None:
            dev = min(alive_l, key=lambda d: (loads[d], d))
        out.append((sid, dev))
        loads[dev] += 1
    return tuple(out)


def plan_rebalance(assignments, alive, *, slack=1, fixed=None):
    """Even out *movable* load: ``((sid, src, dst), ...)`` moves.

    ``assignments`` maps device -> tuple of movable sids (queue order);
    ``fixed`` maps device -> immovable load (slotted viewers: migrating
    those costs state, queued ones are free to move).  Movable sids
    stranded on dead devices evacuate first; then greedy max->min moves
    run until the load spread is within ``slack`` (>= 1: a spread of one
    is already balanced for integer loads).  Deterministic (sorted device
    order, LIFO pops), a no-op when balanced, and never targets a device
    outside ``alive``."""
    alive_l = sorted(alive)
    if not alive_l:
        raise ValueError('plan_rebalance: no alive devices')
    slack = max(1, int(slack))
    fixed = {d: int((fixed or {}).get(d, 0)) for d in alive_l}
    movable = {d: list(assignments.get(d, ())) for d in alive_l}
    moves = []

    def load(d):
        return fixed[d] + len(movable[d])

    for dead in sorted(assignments):
        if dead in movable:
            continue
        for sid in assignments[dead]:
            dst = min(alive_l, key=lambda d: (load(d), d))
            movable[dst].append(sid)
            moves.append((sid, dead, dst))
    while True:
        candidates = [d for d in alive_l if movable[d]]
        if not candidates:
            break
        src = max(candidates, key=lambda d: (load(d), -d))
        dst = min(alive_l, key=lambda d: (load(d), d))
        if load(src) - load(dst) <= slack:
            break
        sid = movable[src].pop()
        movable[dst].append(sid)
        moves.append((sid, src, dst))
    return tuple(moves)


def plan_shrink(victims, free, alive):
    """Device-loss placement: ``(aligned, spilled)``.

    ``victims`` is ``((sid, slot), ...)`` from the lost device's checkpoint;
    ``free`` maps alive device -> iterable of free slot indices.  Each
    victim lands on the lowest-id alive device with **the same slot index**
    free (``aligned``: the only placement whose restored lane replays its
    integer state exactly, since pool ownership and sort-cadence residue
    are keyed by slot index); the rest return as ``spilled`` sids for cold
    re-admission.  Pure and deterministic."""
    alive_l = sorted(alive)
    free = {d: set(free.get(d, ())) for d in alive_l}
    aligned, spilled = [], []
    for sid, slot in victims:
        target = next((d for d in alive_l if slot in free[d]), None)
        if target is None:
            spilled.append(sid)
        else:
            free[target].discard(slot)
            aligned.append((sid, target, slot))
    return tuple(aligned), tuple(spilled)


def viewer_payload_from_state(arrays, meta, slot, viewers_per_scene=1, *,
                              like):
    """Build an ``extract_viewer``-format payload for ``slot`` out of a
    checkpointed ``BatchedStepper.state_dict`` (``arrays`` as
    ``SessionManager._restore_arrays`` loads them, ``meta`` the stepper's
    meta): the device is gone, so its last crash-consistent snapshot is the
    source of truth.  ``like`` is a stepper of the snapshot's geometry,
    whose first camera and empty pool entry give the static fields the
    snapshot does not store.  The tensors stay where ``arrays`` holds them
    (``restore_viewer`` moves them to its device).  Valid for an aligned
    restore only (same slot index, same ``global_tick``; see
    ``BatchedStepper.extract_viewer``)."""
    scene_i = slot // viewers_per_scene
    priv = arrays['priv']
    dev = arrays['cache']['tags'].device
    lane = torch.as_tensor([slot])
    payload = {
        'priv': ViewerPrivate(
            prev_cam=camera_at(camera_from_arrays(like._cam0,
                                                  priv['prev_cam'], dev),
                               lane),
            frame_idx=np.asarray(priv['frame_idx'], np.int64)[[slot]],
            cell_id=np.asarray(priv['cell_id'], np.int64)[[slot]],
            pool_idx=np.array([meta['slot_pool'][slot]], np.int64)),
        'cam': camera_at(camera_from_arrays(like._cam0, arrays['slot_cams'],
                                            dev), lane),
        'frames_since_due': int(meta['frames_since_due'][slot]),
        'pending_sort': slot in set(meta['pending_sort']),
        'shared': None,
        'pool_rows': None,
    }
    if viewers_per_scene == 1:
        payload['shared'] = {
            'cache': CacheState(*(arrays['cache'][f][scene_i].clone()
                                  for f in _CACHE_FIELDS)),
            'pool': tuple(_entry_from(like._empty, e, dev)
                          for e in arrays['pool'][scene_i])}
        payload['pool_rows'] = {
            'pool_cell': np.asarray(meta['pool_cell'][scene_i], np.int64),
            'pool_tick': np.asarray(meta['pool_tick'][scene_i], np.int64),
            'pool_owner': np.asarray(meta['pool_owner'][scene_i], np.int64),
            'slot_pool': int(meta['slot_pool'][slot]),
            'refs': np.asarray(meta['refs'][scene_i], np.int64),
        }
    return payload


def _on_card(device):
    """``torch.cuda.device(device)`` for a card, else nothing."""
    if device is not None and torch.device(device).type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _scene_on(scene: GaussianScene, device) -> GaussianScene:
    """The scene on ``device``: itself when it lies there, else a copy
    (``nn.Module.to`` would move the caller's scene in place)."""
    if scene.device == device:
        return scene
    return GaussianScene(*(getattr(scene, f).detach().to(device)
                           for f in FIELDS))


# -- the fleet ---------------------------------------------------------------

@dataclasses.dataclass
class FleetWorker:
    """One device's serving stack: its own stepper (tensors on ``device``),
    its own ``SessionManager`` with a private metrics registry (``tick.*``
    series are per manager: sharing one registry across workers would
    interleave their tick streams), and optionally its own checkpoint
    directory."""

    device_id: int
    device: object
    mgr: SessionManager
    ckpt: object = None


class FleetManager:
    """Scene-sharded serving across N device workers (see module docs).

    All mutations happen on the driver's main thread at tick boundaries;
    worker ``run_tick`` legs touch only their own worker's state, which is
    what lets ``ThreadedFleetDriver`` run them concurrently without locks
    or divergence from the sync oracle.
    """

    def __init__(self, workers, *, tracer=None, metrics=None, injector=None,
                 max_pending: Optional[int] = None):
        self.workers = list(workers)
        if not self.workers:
            raise ValueError('fleet needs at least one worker')
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.metrics = metrics if metrics is not None else \
            obs_metrics.Registry()
        self.injector = injector if injector is not None else \
            serve_faults.NULL
        self.max_pending = max_pending
        self.alive = {w.device_id for w in self.workers}
        self.tick = 0
        self.pending: deque[ViewerSession] = deque()
        self.shed: list[ViewerSession] = []
        self.sessions: dict[int, ViewerSession] = {}
        self.home: dict[int, int] = {}          # sid -> device
        self.scene_home: dict[int, int] = {}    # scene_id -> device (vps>1)
        #: finished sessions recovered from a lost device's checkpoint meta
        #: (their worker is dead; they are done and must still be counted)
        self.orphan_finished: list[ViewerSession] = []
        self._gauge_alive()

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, scene, cfg, cam0, *, num_devices: int,
              slots_per_device: int, viewers_per_scene: int = 1,
              profile_every: int = 0, ckpt_root=None, ckpt_every: int = 0,
              max_pending: Optional[int] = None, injector=None,
              tracer=None, metrics=None, stepper_cls=BatchedStepper,
              device=None):
        """One worker per device (``launch.mesh.serve_devices(num_devices,
        device)``: distinct cards where there are enough, oversubscribed
        otherwise; the card by default).  Each stepper is built under its
        card's ``torch.cuda.device``, on a copy of the scene and first
        camera on that device when they lie elsewhere."""
        from ..checkpoint.manager import CheckpointManager
        devices = serve_devices(num_devices, device)
        workers = []
        for d, dev in enumerate(devices):
            with _on_card(dev):
                stepper = stepper_cls(
                    _scene_on(scene, dev), cfg, camera_to(cam0, dev),
                    slots_per_device, profile_every=profile_every,
                    viewers_per_scene=viewers_per_scene, device=dev)
            mgr = SessionManager(stepper, slots_per_device,
                                 metrics=obs_metrics.Registry())
            ckpt = None
            if ckpt_root is not None:
                # the manager exists whenever a checkpoint root is named: a
                # restore-only launch (ckpt_every == 0) must still be able
                # to read the previous run's snapshots
                ckpt = CheckpointManager(Path(ckpt_root) / f'device{d}',
                                         metrics=mgr.metrics)
                if ckpt_every > 0:
                    mgr.enable_checkpoints(ckpt, ckpt_every)
            workers.append(FleetWorker(d, dev, mgr, ckpt))
        return cls(workers, tracer=tracer, metrics=metrics,
                   injector=injector, max_pending=max_pending)

    def _bind(self, sess: ViewerSession, w: FleetWorker) -> None:
        """Put a session's cameras on its worker's device (a no-op while
        they lie there, as on one card)."""
        if w.device is None or not sess.cams:
            return
        dev = torch.device(w.device)
        at = sess.cams[0].position.device
        if at.type != dev.type or (dev.index is not None
                                   and at.index != dev.index):
            sess.cams = [camera_to(c, dev) for c in sess.cams]

    def _bind_all(self) -> None:
        for w in self.alive_workers():
            m = w.mgr
            for sess in [s for s in m.slot_session if s is not None] \
                    + [s for lst in m._coresidents.values() for s in lst] \
                    + list(m.pending):
                self._bind(sess, w)

    # -- restore at launch -------------------------------------------------

    def restore_at_launch(self, sessions) -> Optional[int]:
        """Restore the whole fleet from its newest *common* snapshot step.

        Lockstep checkpointing normally leaves every worker with the same
        step set, but a kill can land mid-save on one device, so the fleet
        restores to the newest step EVERY worker holds (``max_step``
        threads through ``SessionManager.restore_serving``), keeping the
        resumed state crash-consistent fleet-wide.  Fleet-level placement
        (``home``/``scene_home``) rebuilds from the restored workers;
        sessions absent from every snapshot (accepted after it, or never
        routed) re-queue from frame 0.  Returns the restored fleet tick,
        or None when any worker lacks a usable snapshot (the caller decides
        whether that is fatal)."""
        steps = []
        for w in self.workers:
            if w.ckpt is None:
                return None
            w.ckpt.wait()
            steps.append(set(w.ckpt.all_steps()))
        common = set.intersection(*steps)
        if not common:
            return None
        step = max(common)
        self.sessions = {s.sid: s for s in sessions}
        for w in self.workers:
            if w.mgr.restore_serving(w.ckpt, sessions,
                                     max_step=step) is None:
                return None
        ticks = {w.mgr.tick for w in self.workers}
        if len(ticks) != 1:
            raise RuntimeError(f'fleet checkpoints out of sync at restore: '
                               f'ticks {sorted(ticks)}')
        self.tick = ticks.pop()
        vps = max(getattr(w.mgr.stepper, 'viewers_per_scene', 1)
                  for w in self.workers)
        self.home = {}
        self.scene_home = {}
        placed = set()
        for w in self.workers:
            for sess in w.mgr.slot_session:
                if sess is None:
                    continue
                self.home[sess.sid] = w.device_id
                placed.add(sess.sid)
                if vps > 1:
                    self.scene_home.setdefault(sess.scene_id, w.device_id)
            for lst in w.mgr._coresidents.values():
                for sess in lst:
                    self.home[sess.sid] = w.device_id
                    placed.add(sess.sid)
            for sess in w.mgr.pending:
                self.home[sess.sid] = w.device_id
                placed.add(sess.sid)
            placed |= {s.sid for s in w.mgr.finished}
            placed |= {s.sid for s in w.mgr.shed}
        requeue = [self.sessions[sid] for sid in sorted(self.sessions)
                   if sid not in placed]
        for sess in requeue:
            sess.cursor = 0
            sess.telemetry.rollback(0)
            sess.telemetry.admitted_tick = -1
        self.pending = deque(sorted(requeue,
                                    key=lambda s: (s.arrival_tick, s.sid)))
        self._bind_all()
        self.metrics.counter('fleet.restores',
                             'fleet runs resumed from checkpoints').inc()
        self.tracer.instant('fleet_restore', tick=self.tick, step=step)
        return self.tick

    # -- admission ---------------------------------------------------------

    def submit(self, session: ViewerSession) -> bool:
        """Bounded fleet-level admission: beyond ``max_pending`` queued
        sessions the arrival is shed (recorded and counted), never silently
        dropped: degraded capacity sheds NEW load; accepted viewers always
        drain."""
        if self.max_pending is not None \
                and len(self.pending) >= self.max_pending:
            self.shed.append(session)
            self.metrics.counter(
                'fleet.shed',
                'arrivals rejected by the bounded fleet queue').inc()
            return False
        self.pending.append(session)
        self.sessions[session.sid] = session
        self.metrics.gauge('fleet.pending_depth',
                           'fleet admission queue depth').set(
                               len(self.pending))
        return True

    # -- tick legs (shared by both fleet drivers) --------------------------

    def alive_workers(self) -> list[FleetWorker]:
        return [w for w in self.workers if w.device_id in self.alive]

    def _check_device_loss(self) -> None:
        """Consume a pending ``device_loss`` event at the tick boundary."""
        if not self.injector.enabled:
            return
        ev = self.injector.take('device_loss', self.tick)
        if ev is None:
            return
        victim = ev.slot if ev.slot in self.alive else max(self.alive)
        if len(self.alive) <= 1:
            warnings.warn(
                f'device_loss at tick {self.tick} ignored: device '
                f'{victim} is the last alive device (a real loss here is '
                f'a total outage, not a shrink)', RuntimeWarning,
                stacklevel=2)
            self.metrics.counter(
                'fleet.device_loss_ignored',
                'loss events on the last alive device').inc()
            return
        self.lose_device(victim)

    def _route_tick(self) -> None:
        """Route arrived queued sessions onto alive workers."""
        arrived = [s for s in self.pending if s.arrival_tick <= self.tick]
        if not arrived:
            return
        vps = max(getattr(w.mgr.stepper, 'viewers_per_scene', 1)
                  for w in self.workers)
        # resident_count (not occupied-slot count): an oversubscribed slot
        # carries several paced viewers and weighs as all of them
        loads = {w.device_id: w.mgr.resident_count() + len(w.mgr.pending)
                 for w in self.alive_workers()}
        routes = plan_route(
            tuple((s.sid, s.scene_id) for s in arrived), loads, self.alive,
            scene_home=self.scene_home if vps > 1 else None)
        by_sid = {s.sid: s for s in arrived}
        for sid, dev in routes:
            sess = by_sid[sid]
            self.pending.remove(sess)
            self._bind(sess, self.workers[dev])
            self.workers[dev].mgr.submit(sess)
            self.home[sid] = dev
            if vps > 1:
                self.scene_home.setdefault(sess.scene_id, dev)
            self.metrics.counter('fleet.routed',
                                 'sessions routed to a device worker',
                                 device=dev).inc()
        self.metrics.gauge('fleet.pending_depth',
                           'fleet admission queue depth').set(
                               len(self.pending))

    def _worker_tick(self, w: FleetWorker) -> int:
        """One worker's tick leg, under its card's ``torch.cuda.device``:
        run, evict, and keep the stepper clock in lockstep (idle ticks
        advance ``global_tick`` too: the fleet-wide shared sort-cadence
        clock that slot-aligned moves rely on)."""
        with _on_card(w.device):
            frames = w.mgr.run_tick()
            stepper = w.mgr.stepper
            if getattr(stepper, 'global_tick', w.mgr.tick) < w.mgr.tick:
                stepper.global_tick = w.mgr.tick
            w.mgr.evict_finished()
        return frames

    def _after_tick(self) -> None:
        self.tick += 1
        for w in self.alive_workers():
            w.mgr.maybe_checkpoint()

    def run_tick(self) -> int:
        """One synchronous fleet tick (the virtual N-device oracle leg)."""
        self._check_device_loss()
        self._route_tick()
        frames = 0
        for w in self.alive_workers():
            frames += self._worker_tick(w)
        self._after_tick()
        return frames

    # -- live migration ----------------------------------------------------

    def migrate(self, sid: int, dst: int) -> Optional[int]:
        """Move one slotted viewer to device ``dst`` at a tick boundary.

        Slot-aligned moves (the same slot index is free on ``dst``, private
        scene blocks) carry the whole scene lane.  Otherwise the viewer
        restores cold into the lowest free slot and re-sorts on admission
        (at most one sort window of staleness).  With no free slot on
        ``dst`` the viewer re-queues on the fleet with its cursor
        preserved.  Returns the destination slot, or None when
        re-queued."""
        if dst not in self.alive:
            raise ValueError(f'migrate: device {dst} is not alive')
        src = self.home.get(sid)
        if src is None or src not in self.alive:
            raise ValueError(f'migrate: sid {sid} has no alive home device')
        if src == dst:
            raise ValueError(f'migrate: sid {sid} already on device {dst}')
        sw, dw = self.workers[src], self.workers[dst]
        slot = next((i for i, s in enumerate(sw.mgr.slot_session)
                     if s is not None and s.sid == sid), None)
        if slot is None:
            raise ValueError(f'migrate: sid {sid} is not slotted on '
                             f'device {src}')
        if getattr(sw.mgr, '_coresidents', {}).get(slot):
            raise ValueError(
                f'migrate: slot {slot} on device {src} is oversubscribed: '
                f'stashed co-residents cannot follow a single-viewer move')
        free = dw.mgr.free_slots()
        if not free:
            sess = sw.mgr.vacate(slot)
            sess.telemetry.admitted_tick = -1
            self.pending.append(sess)
            self.home.pop(sid, None)
            self.metrics.counter('fleet.migrations',
                                 'viewer moves between devices',
                                 kind='requeued').inc()
            return None
        vps1 = getattr(sw.mgr.stepper, 'viewers_per_scene', 1) == 1
        aligned = vps1 and slot in free
        payload = sw.mgr.stepper.extract_viewer(slot, with_scene=aligned)
        sess = sw.mgr.vacate(slot)
        target = slot if aligned else free[0]
        self._bind(sess, dw)
        with _on_card(dw.device):
            dw.mgr.place(target, sess, payload=payload,
                         admitted_tick=sess.telemetry.admitted_tick)
        self.home[sid] = dst
        self.metrics.counter('fleet.migrations',
                             'viewer moves between devices',
                             kind='aligned' if aligned else 'cold').inc()
        return target

    # -- device loss -------------------------------------------------------

    def lose_device(self, victim: int) -> None:
        """Shrink the fleet: mark ``victim`` dead and migrate every session
        off it (checkpoint rollback when available, cold re-queue
        otherwise).  No viewer is dropped either way."""
        if victim not in self.alive:
            raise ValueError(f'device {victim} is not alive')
        if len(self.alive) <= 1:
            raise ValueError('cannot lose the last alive device')
        vw = self.workers[victim]
        self.alive.discard(victim)
        self.metrics.counter('fleet.device_lost',
                             'devices dropped from the fleet',
                             device=victim).inc()
        self.tracer.instant('device_loss', device=victim, tick=self.tick)
        with self.tracer.span('device_recovery', device=victim,
                              tick=self.tick):
            if vw.ckpt is not None and vw.ckpt.latest() is not None:
                self._recover_from_checkpoint(vw)
            else:
                self._recover_cold(vw)
        self._gauge_alive()

    def _gauge_alive(self) -> None:
        self.metrics.gauge('fleet.alive_devices',
                           'devices currently serving').set(len(self.alive))

    def _recover_cold(self, vw: FleetWorker) -> None:
        """No checkpoint: host-side cursors are crash-consistent in-process
        (every delivered frame advanced them before the loss), so victims
        re-queue at their current frame and re-admit cold on survivors.
        Rendered frames are never re-rendered; the viewers just lose their
        warm caches."""
        mgr = vw.mgr
        victims = [mgr.vacate(slot) for slot in mgr.active_slots()]
        victims.extend(mgr.pending)
        mgr.pending.clear()
        self.orphan_finished.extend(mgr.finished)
        mgr.finished = []
        for sess in sorted(victims, key=lambda s: (s.arrival_tick, s.sid)):
            sess.telemetry.admitted_tick = -1
            self.home.pop(sess.sid, None)
            self.pending.append(sess)
        self.scene_home = {sc: d for sc, d in self.scene_home.items()
                           if d != vw.device_id}
        self.metrics.counter('fleet.requeued',
                             'sessions re-queued off a lost device').inc(
                                 len(victims))

    def _recover_from_checkpoint(self, vw: FleetWorker) -> None:
        """Whole-fleet rollback to the last crash-consistent snapshot.

        All workers checkpoint at the same tick multiples under the
        lockstep clock, so the newest per-device checkpoints form one
        consistent fleet state.  Survivors restore their own snapshots;
        the victim's snapshot is read into host memory and its viewers
        shrink onto survivors via ``plan_shrink``.  Replay from the
        snapshot is at-least-once delivery: telemetry rolls back so
        nothing is counted twice."""
        for w in self.workers:
            if w.ckpt is not None:
                w.ckpt.wait()
        all_sessions = list(self.sessions.values())
        survivors = self.alive_workers()
        ticks = set()
        for w in survivors:
            step = w.mgr.restore_serving(w.ckpt, all_sessions)
            if step is None:
                raise RuntimeError(
                    f'device {w.device_id} has no usable checkpoint: '
                    f'fleet snapshots are taken in lockstep, so this is '
                    f'checkpoint corruption, not a race')
            ticks.add(w.mgr.tick)
        if len(ticks) != 1:
            raise RuntimeError(f'fleet checkpoints out of sync: restored '
                               f'ticks {sorted(ticks)}')
        restore_tick = ticks.pop()
        for w in survivors:
            # rolled-back frames will replay: truncate per-session frame
            # telemetry to the restored cursors and drop post-snapshot tick
            # log entries (restore_serving leaves pending cursors alone: a
            # fresh-process restore never needed the fix-up, an in-process
            # rollback does)
            for sess in w.mgr.slot_session:
                if sess is not None:
                    sess.telemetry.rollback(sess.cursor)
            for lst in w.mgr._coresidents.values():
                for sess in lst:
                    sess.telemetry.rollback(sess.cursor)
            for sess in w.mgr.pending:
                sess.cursor = 0
                sess.telemetry.rollback(0)
                sess.telemetry.admitted_tick = -1
            w.mgr.tick_log = [t for t in w.mgr.tick_log
                              if t['tick'] < restore_tick]

        # the victim's snapshot, read into host memory (per-step shape
        # template: the snapshot's pool capacity is part of its geometry)
        out = vw.mgr._restore_arrays(vw.ckpt, device=torch.device('cpu'))
        if out is None:
            raise RuntimeError(f'device {vw.device_id}: checkpoint '
                               f'vanished between latest() and restore')
        arrays, _step, meta = out
        if int(meta['tick']) != restore_tick:
            raise RuntimeError(
                f'victim checkpoint tick {meta["tick"]} != fleet restore '
                f'tick {restore_tick}')
        vps = getattr(vw.mgr.stepper, 'viewers_per_scene', 1)
        slotted = [(m['sid'], slot, int(m['cursor']),
                    int(m['admitted_tick']))
                   for slot, m in enumerate(meta['slots']) if m is not None]
        info = {sid: (cursor, adm) for sid, _, cursor, adm in slotted}
        free = {w.device_id: tuple(w.mgr.free_slots()) for w in survivors}
        aligned, spilled = plan_shrink(
            tuple((sid, slot) for sid, slot, _, _ in slotted), free,
            self.alive)
        for sid, dev, slot in aligned:
            sess = self.sessions[sid]
            cursor, adm = info[sid]
            sess.cursor = cursor
            sess.telemetry.rollback(cursor)
            payload = viewer_payload_from_state(
                arrays, meta['stepper'], slot, viewers_per_scene=vps,
                like=vw.mgr.stepper)
            dw = self.workers[dev]
            self._bind(sess, dw)
            with _on_card(dw.device):
                dw.mgr.place(slot, sess, payload=payload, admitted_tick=adm)
            self.home[sid] = dev
            self.metrics.counter('fleet.migrations',
                                 'viewer moves between devices',
                                 kind='loss_aligned').inc()
        requeue = []
        for sid in spilled:
            sess = self.sessions[sid]
            cursor, _adm = info[sid]
            sess.cursor = cursor
            sess.telemetry.rollback(cursor)
            sess.telemetry.admitted_tick = -1
            self.home.pop(sid, None)
            requeue.append(sess)
            self.metrics.counter('fleet.migrations',
                                 'viewer moves between devices',
                                 kind='loss_spilled').inc()
        # stashed co-residents of the victim's oversubscribed slots restore
        # cold onto the fleet queue with their cursors preserved: their
        # lane context died with the device, but not their progress
        for lst in meta.get('coresidents', {}).values():
            for m in lst:
                sess = self.sessions[m['sid']]
                sess.cursor = int(m['cursor'])
                sess.telemetry.rollback(sess.cursor)
                sess.telemetry.admitted_tick = -1
                self.home.pop(m['sid'], None)
                requeue.append(sess)
                self.metrics.counter('fleet.migrations',
                                     'viewer moves between devices',
                                     kind='loss_spilled').inc()
        for sid in meta['pending']:
            sess = self.sessions[sid]
            sess.cursor = 0
            sess.telemetry.rollback(0)
            sess.telemetry.admitted_tick = -1
            self.home.pop(sid, None)
            requeue.append(sess)
        for sid in meta['finished']:
            sess = self.sessions[sid]
            sess.cursor = len(sess.cams)
            self.orphan_finished.append(sess)
        # the victim's live (post-snapshot) state is dead with the device
        vw.mgr.slot_session = [None] * vw.mgr.slots
        vw.mgr._coresidents = {}
        vw.mgr.pending.clear()
        vw.mgr.finished = []
        vw.mgr.tick_log = [t for t in vw.mgr.tick_log
                           if t['tick'] < restore_tick]
        self.scene_home = {sc: d for sc, d in self.scene_home.items()
                           if d != vw.device_id}

        # reconcile: sessions accepted after the snapshot are nowhere in
        # the restored state: they restart from frame 0
        placed = {s.sid for s in self.orphan_finished}
        placed |= {s.sid for s in requeue}
        placed |= {s.sid for s in self.pending}
        placed |= {s.sid for s in self.shed}
        for w in survivors:
            placed |= {s.sid for s in w.mgr.slot_session if s is not None}
            placed |= {s.sid for lst in w.mgr._coresidents.values()
                       for s in lst}
            placed |= {s.sid for s in w.mgr.pending}
            placed |= {s.sid for s in w.mgr.finished}
        for sid in sorted(self.sessions):
            if sid in placed:
                continue
            sess = self.sessions[sid]
            sess.cursor = 0
            sess.telemetry.rollback(0)
            sess.telemetry.admitted_tick = -1
            self.home.pop(sid, None)
            requeue.append(sess)
        merged = list(self.pending) + requeue
        self.pending = deque(sorted(merged,
                                    key=lambda s: (s.arrival_tick, s.sid)))
        self.metrics.counter('fleet.requeued',
                             'sessions re-queued off a lost device').inc(
                                 len(requeue))
        self.tick = restore_tick
        self._bind_all()

    # -- draining / results ------------------------------------------------

    def drained(self) -> bool:
        return (not self.pending
                and all(w.mgr.drained() for w in self.alive_workers()))

    def finished_sessions(self) -> list[ViewerSession]:
        out = list(self.orphan_finished)
        for w in self.workers:
            out.extend(w.mgr.finished)
        return sorted(out, key=lambda s: s.sid)

    def summaries(self) -> list[dict]:
        return [s.telemetry.summary() for s in self.finished_sessions()]

    def aggregate(self) -> dict:
        agg = serve_telemetry.aggregate(self.summaries())
        agg['devices'] = len(self.workers)
        agg['alive_devices'] = len(self.alive)
        agg['shed'] = len(self.shed)
        return agg

    def merged_tick_log(self) -> list[dict]:
        """All workers' tick logs in tick order (ticks repeat across
        workers and, after a rollback, replayed ranges repeat in time;
        per-frame percentiles over the merged log are at-least-once
        accounting, consistent with the replayed frames)."""
        log = []
        for w in self.workers:
            log.extend(w.mgr.tick_log)
        return sorted(log, key=lambda t: t['tick'])


# -- fleet drivers -----------------------------------------------------------

class SyncFleetDriver:
    """The virtual N-device oracle: workers tick sequentially in device
    order on a pure tick counter, the baseline ``ThreadedFleetDriver`` is
    judged against."""

    def __init__(self, fleet: FleetManager):
        self.fleet = fleet

    def run_tick(self) -> int:
        return self.fleet.run_tick()

    def run(self, max_ticks: int = 100_000) -> list[ViewerSession]:
        fleet = self.fleet
        while not fleet.drained():
            self.run_tick()
            if fleet.tick >= max_ticks:
                raise RuntimeError('fleet serve loop did not drain')
        return fleet.finished_sessions()


class ThreadedFleetDriver:
    """Real-time fleet driver: one persistent thread per worker, barrier at
    every tick boundary.

    Main-thread loop per fleet tick::

        _check_device_loss()        # consume device_loss, maybe shrink
        _route_tick()               # fleet queue -> worker queues
        cmd[w].put(tick)            # alive workers tick concurrently
        barrier: done[w].get()      # collect frames + wall time per worker
        straggler.observe_step(...) # EWMA per device; optional exclusion
        _after_tick()               # clock + lockstep checkpoints

    Workers touch disjoint state and run the same ``run_tick`` code as the
    sync oracle, and every fleet-level decision happens between barriers on
    the main thread, so the control flow (and so the cache tags, sort
    cadence and images) is the sync oracle's; only wall-clock telemetry
    differs.  ``exclude_stragglers=True`` trades that determinism for
    availability: a device flagged by the ``StragglerDetector``
    (threshold x fleet-median EWMA, ``patience`` consecutive slow ticks)
    is dropped via ``lose_device`` at the next boundary."""

    JOIN_TIMEOUT_S = 5.0

    def __init__(self, fleet: FleetManager, *,
                 exclude_stragglers: bool = False,
                 straggler_threshold: float = 1.25,
                 straggler_patience: int = 3,
                 watchdog_s: Optional[float] = None):
        self.fleet = fleet
        self.exclude_stragglers = exclude_stragglers
        self.detector = StragglerDetector(
            len(fleet.workers), threshold=straggler_threshold,
            patience=straggler_patience, metrics=fleet.metrics)
        self.watchdog_s = watchdog_s if watchdog_s is not None \
            else SessionManager.default_watchdog_s
        self._cmd: dict[int, queue.Queue] = {}
        self._done: dict[int, queue.Queue] = {}
        self._threads: dict[int, threading.Thread] = {}

    # -- worker lifecycle --------------------------------------------------

    def _start(self) -> None:
        for w in self.fleet.workers:
            cmd: queue.Queue = queue.Queue()
            done: queue.Queue = queue.Queue()

            def loop(w=w, cmd=cmd, done=done):
                while True:
                    msg = cmd.get()
                    if msg is None:
                        return
                    t0 = time.perf_counter()
                    try:
                        frames = self.fleet._worker_tick(w)
                        done.put(('ok', frames,
                                  time.perf_counter() - t0))
                    except BaseException as exc:
                        # handed to the main thread, which re-raises it
                        done.put(('error', exc,
                                  time.perf_counter() - t0))

            th = threading.Thread(
                target=loop, name=f'fleet-worker-{w.device_id}',
                daemon=True)
            th.start()
            self._cmd[w.device_id] = cmd
            self._done[w.device_id] = done
            self._threads[w.device_id] = th

    def _stop(self) -> None:
        for cmd in self._cmd.values():
            cmd.put(None)
        for th in self._threads.values():
            th.join(timeout=self.JOIN_TIMEOUT_S)
            if th.is_alive():
                self.fleet.metrics.counter(
                    'serve.thread_leaks',
                    'planner threads alive past their join deadline').inc()
                warnings.warn(f'{th.name} did not exit within '
                              f'{self.JOIN_TIMEOUT_S}s; daemon thread '
                              f'leaked', RuntimeWarning, stacklevel=2)
        self._cmd, self._done, self._threads = {}, {}, {}

    # -- the loop ----------------------------------------------------------

    def run_tick(self) -> int:
        fleet = self.fleet
        fleet._check_device_loss()
        fleet._route_tick()
        alive = fleet.alive_workers()
        for w in alive:
            self._cmd[w.device_id].put(fleet.tick)
        frames = 0
        timings: dict[int, float] = {}
        failures = []
        for w in alive:
            try:
                kind, payload, dt = self._done[w.device_id].get(
                    timeout=self.watchdog_s)
            except queue.Empty:
                raise RuntimeError(
                    f'fleet watchdog: device {w.device_id} posted no tick '
                    f'completion within {self.watchdog_s}s') from None
            if kind == 'error':
                failures.append((w.device_id, payload))
                continue
            frames += payload
            timings[w.device_id] = dt
        if failures:
            dev, exc = failures[0]
            raise RuntimeError(
                f'fleet worker {dev} failed at tick {fleet.tick}') from exc
        flagged = self.detector.observe_step(timings)
        if self.exclude_stragglers:
            for dev in sorted(flagged):
                if dev in fleet.alive and len(fleet.alive) > 1:
                    warnings.warn(
                        f'excluding straggler device {dev} at tick '
                        f'{fleet.tick}', RuntimeWarning, stacklevel=2)
                    fleet.lose_device(dev)
        fleet._after_tick()
        return frames

    def run(self, max_ticks: int = 100_000) -> list[ViewerSession]:
        fleet = self.fleet
        self._start()
        try:
            while not fleet.drained():
                self.run_tick()
                if fleet.tick >= max_ticks:
                    raise RuntimeError('fleet serve loop did not drain')
        finally:
            self._stop()
        return fleet.finished_sessions()


FLEET_DRIVERS = {'sync': SyncFleetDriver, 'threaded': ThreadedFleetDriver}


def get_fleet_driver(name: str, fleet: FleetManager, **kw):
    try:
        return FLEET_DRIVERS[name](fleet, **kw)
    except KeyError:
        raise ValueError(f'unknown fleet driver {name!r} '
                         f'(expected one of {sorted(FLEET_DRIVERS)})') \
            from None


def serve_fleet(scene, cfg, cam0, sessions, *, num_devices: int,
                slots_per_device: int, driver: str = 'sync',
                viewers_per_scene: int = 1, profile_every: int = 0,
                ckpt_root=None, ckpt_every: int = 0, restore: bool = False,
                max_pending: Optional[int] = None, injector=None,
                tracer=None, max_ticks: int = 100_000, device=None,
                **driver_kw) -> tuple:
    """Build a fleet, submit ``sessions``, drive it to drain.

    ``restore=True`` resumes from the newest fleet-consistent snapshot
    under ``ckpt_root`` (``FleetManager.restore_at_launch``) instead of
    starting cold, and fails fast with ``SystemExit`` when no usable
    snapshot exists, because silently starting over is exactly the fault
    this flag guards against.  The restored tick lands on
    ``fleet.restored_tick`` (None for a cold start).  ``device`` places the
    workers (``launch.mesh.serve_devices``; the card by default).

    Returns ``(fleet, finished_sessions)``; end-of-run fault accounting
    (``serve.faults_unfired``) runs against the fleet registry."""
    if restore and ckpt_root is None:
        raise SystemExit('--restore with --devices > 1 needs '
                         '--checkpoint-dir (the fleet restores from '
                         'per-device lockstep snapshots)')
    fleet = FleetManager.build(
        scene, cfg, cam0, num_devices=num_devices,
        slots_per_device=slots_per_device,
        viewers_per_scene=viewers_per_scene, profile_every=profile_every,
        ckpt_root=ckpt_root, ckpt_every=ckpt_every,
        max_pending=max_pending, injector=injector, tracer=tracer,
        device=device)
    fleet.restored_tick = None
    if restore:
        restored = fleet.restore_at_launch(sessions)
        if restored is None:
            raise SystemExit(
                f'--restore: no usable fleet checkpoint under {ckpt_root} '
                f'(every device worker needs a complete snapshot at a '
                f'common step)')
        fleet.restored_tick = restored
    else:
        for sess in sessions:
            fleet.submit(sess)
    drv = get_fleet_driver(driver, fleet, **driver_kw)
    finished = drv.run(max_ticks)
    for w in fleet.workers:
        if w.ckpt is not None:
            w.ckpt.wait()
    if fleet.injector.enabled:
        serve_faults.account_unfired(fleet.injector, fleet.metrics)
    return fleet, finished
