"""Slot steppers: how a set of viewer slots advances one frame.

Two engines behind one interface:

* ``BatchedStepper`` — the serving fast path over scene-centric state.
  Slots are partitioned into scenes (``viewers_per_scene`` slots per scene,
  a static block layout); each scene holds one radiance cache and a
  pose-cell-keyed pool of speculative-sort entries (``SceneShared`` in its
  scene-major form), while per-slot state is a ``ViewerPrivate`` in its
  slot-major form.  A **pose-cell sort scheduler** decides the sorts: slot
  ``i`` comes due when ``global_tick % window == i % window`` (plus
  sort-on-admit, and a catch-up for paced slots), due slots are grouped by
  (scene, pose cell), and each group elects one leader (lowest slot) to run
  the speculative sort, so co-located viewers share one entry.  A due group
  whose cell already holds a fresh entry (sorted within the window by a
  still-active owner still in that cell) adopts it without sorting.  Each
  tick then advances the live slots through one ``batched_shade_phase``,
  whose cache stages run scene-major.
* ``SequentialStepper`` — each active slot advances through its own
  ``render_step`` (per-viewer sort cadence, fully private state): the
  reference the batched engine is held against.

With ``viewers_per_scene == 1`` every slot is its own scene: a private
cache and singleton pose-cell groups.  For one viewer in slot 0 admitted at
tick 0 the two engines make the same decisions.

**Idle-lane compaction.**  When whole scenes are idle, the batched engine
gathers the active scene blocks into a prefix (padded to a power-of-two
bucket of scenes), shades only that, and writes the results back in place;
idle scenes are not shaded.  When the busiest active scene has fewer live
lanes than a block, only each scene's live lanes are gathered (padded to a
power-of-two lane bucket with inert duplicates).  Idle slots inside a
shaded block ride with ``active=False``: they contribute nothing, touch no
LRU state and insert nothing.  The buckets are the JAX package's, which
bounds its compiled shapes; they are kept here because the padded lanes
enter the fleet's chunk counts (``saved_frac``), which must equal JAX's.

**Per-kernel latency attribution.**  With ``profile_every=N`` on the kernel
backend, every Nth tick re-runs the shade on a clone of the pre-shade state
split into its stages (prep, prefix, lookup, resume, insert), each timed
with CUDA events on the card (the host clock on the CPU).  The breakdown
lands in ``TickTiming.kernel_ms``.

State updates: a shade returns new cache tensors; the sub-batch results of
a compacted tick and the cold-start of an admitted scene are written into
the fleet's tensors in place (what the JAX package gets from donating its
buffers).

Interface::

    stepper.admit(slot)                  # reset a slot to cold-start state
    out = stepper.step({slot: cam, ..})  # advance the given slots one frame
    # out: {slot: (image, FrameStats, TickTiming)}
    plan = stepper.plan_step(cams)       # pure host planning
    infl = stepper.step_dispatch(cams, plan)  # host mutations + dispatch
    out = stepper.step_finish(infl)      # wait for the device, assemble
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import posecell
from ..core import radiance_cache as rc
from ..core.buckets import pow2_bucket
from ..core.camera import (Camera, camera_arrays, camera_at, camera_to,
                           camera_from_arrays, stack_cameras)
from ..core.gaussians import GaussianScene
from ..core.groups import regroup_slots, ungroup_slots
from ..core.pipeline import (LuminaConfig, SceneShared, ViewerPrivate,
                             ViewerState, batched_prep_features,
                             batched_shade_phase,
                             batched_sort_phase, init_fleet,
                             init_viewer_state,
                             privates_at, render_step, stats_at,
                             trim_features_slots)
from ..core.projection import Projected
from ..core.s2 import SortShared, empty_sort_shared
from ..core.tiling import tile_grid
from ..device import check_on, resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


class TickTiming(NamedTuple):
    """Per-phase latency attribution for the tick a frame rode in."""

    latency_s: float     # wall-clock of the whole tick (sort + shade)
    sort_ms: float       # wall-clock of the tick's sorts
    shade_ms: float      # wall-clock of the tick's shade
    sorted_slots: int    # speculative sorts executed this tick (incl. admits)
    kernel_ms: Optional[dict] = None  # per-stage shade breakdown (profiled
                                      # ticks on the kernel backend)


class _SortGroup(NamedTuple):
    """One due (scene, cell) group resolved by the pose-cell scheduler."""

    scene: int
    cell: int
    leader: int          # lowest due slot; runs the sort if one is needed
    members: tuple       # all due slots adopting the entry
    riders: tuple        # non-due co-located slots consolidated onto it
    entry: int           # pool index the group lands in
    sorts: bool          # False = adopted a fresh entry, no sort executed


class _StepPlan(NamedTuple):
    """Host scheduling for one ``step(cams)`` call (``plan_step``)."""

    active: frozenset    # slots rendering this step
    admits: tuple        # slots sorting on admit (outside the cohort)
    due: tuple           # all slots consuming a sort refresh this step
    groups: tuple        # _SortGroup plan from the pose-cell scheduler
    stream: object = None  # StreamPlan when scene residency is streamed


class _InFlight(NamedTuple):
    """A dispatched, unfinished batched step."""

    cams: dict           # the step's {slot: cam} request
    images: object       # [lanes, H, W, 3]
    stats: object        # FrameStats with [lanes] leaves
    pos: dict            # slot -> lane in images/stats
    t0: float            # perf_counter at step start
    t1: float            # perf_counter at shade dispatch
    sort_s: float        # seconds of the sort phase
    n_sched: int
    n_admit: int
    profile: object      # (shared clone, priv, cam_b, active mask) or None
    tick: int = 0        # global_tick the step ran at


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _entry_bytes(entry) -> int:
    proj, lists = entry.proj, entry.lists
    return sum(x.nbytes for x in (proj.mean2d, proj.conic, proj.radius,
                                  proj.depth, proj.color, proj.opacity,
                                  proj.valid, lists.indices, lists.count))


def _cache_rows(cache: rc.CacheState, idx) -> rc.CacheState:
    return rc.CacheState(cache.tags[idx], cache.values[idx], cache.age[idx],
                         cache.clock[idx])


# -- the saved form of the serving state ------------------------------------
# A saved state is nested dicts of tensors and numpy arrays (what
# ``repro_torch.checkpoint`` flattens by name); the objects are rebuilt
# around them from the stepper's own templates on load.

_CACHE_FIELDS = ('tags', 'values', 'age', 'clock')


def _take(copy: bool):
    return torch.clone if copy else (lambda x: x)


def _cache_arrays(cache: rc.CacheState, copy: bool) -> dict:
    take = _take(copy)
    return {f: take(getattr(cache, f)) for f in _CACHE_FIELDS}


def _cache_from(arrays: dict, device) -> rc.CacheState:
    return rc.CacheState(*(torch.as_tensor(arrays[f]).to(device, copy=True)
                           for f in _CACHE_FIELDS))


def _entry_arrays(entry: SortShared, copy: bool) -> dict:
    take = _take(copy)
    proj = entry.proj
    return {'proj': {f.name: take(getattr(proj, f.name))
                     for f in dataclasses.fields(proj)},
            'indices': take(entry.lists.indices),
            'count': take(entry.lists.count)}


def _entry_from(empty: SortShared, arrays: dict, device) -> SortShared:
    """A pool entry with ``empty``'s static fields and the saved tensors."""
    def t(x):
        return torch.as_tensor(x).to(device, copy=True)
    return dataclasses.replace(
        empty, proj=Projected(**{k: t(v) for k, v in arrays['proj'].items()}),
        lists=dataclasses.replace(empty.lists, indices=t(arrays['indices']),
                                  count=t(arrays['count'])))


def _priv_arrays(priv: ViewerPrivate, copy: bool) -> dict:
    """A slot-major ``ViewerPrivate`` without its pool index (the meta's
    ``slot_pool`` carries that)."""
    return {'prev_cam': camera_arrays(priv.prev_cam, copy),
            'frame_idx': np.array(priv.frame_idx),
            'cell_id': np.array(priv.cell_id)}


def _payload_on(payload: dict, device: torch.device) -> dict:
    """An ``extract_viewer`` payload with its tensors on ``device``: the
    payload itself when they lie there already, else a copy moved there (a
    viewer moving between two cards)."""
    at = payload['cam'].position.device
    if at.type == device.type and (device.index is None
                                   or at.index == device.index):
        return payload
    out = dict(payload)
    priv = payload['priv']
    out['priv'] = dataclasses.replace(
        priv, prev_cam=camera_to(priv.prev_cam, device))
    out['cam'] = camera_to(payload['cam'], device)
    block = payload.get('shared')
    if block is not None:
        out['shared'] = {
            'cache': rc.CacheState(*(getattr(block['cache'], f).to(device)
                                     for f in _CACHE_FIELDS)),
            'pool': tuple(_entry_from(e, _entry_arrays(e, copy=False), device)
                          for e in block['pool'])}
    return out


class BatchedStepper:
    """All live slots advance in one scene-major ``batched_shade_phase``
    per tick (gathered to a dense scene or lane prefix when some are idle);
    speculative sorts run once per due (scene, pose-cell) group.

    ``device`` defaults to the card and raises when none is present; the
    scene and cameras must lie on it.

    ``streaming`` is a ``repro_torch.serve.streaming.ResidencyManager``:
    the effective scene is then the manager's masked arena (the same shape
    every tick), and each tick's residency is planned first in
    ``plan_step`` and applied in ``step_dispatch``."""

    def __init__(self, scene: GaussianScene, cfg: LuminaConfig,
                 cam0: Camera, slots: int, profile_every: int = 0,
                 viewers_per_scene: int = 1, *, streaming=None,
                 device=None):
        if slots % viewers_per_scene:
            raise ValueError(f'slots ({slots}) must be a multiple of '
                             f'viewers_per_scene ({viewers_per_scene})')
        self.device = resolve_device(device)
        self._streaming = streaming
        if streaming is not None:
            if streaming.grace_ticks is None:
                # eviction grace must outlive any stale sorted tile list:
                # one full sort window plus dispatch slack
                streaming.grace_ticks = (max(1, cfg.window)
                                         if cfg.use_s2 else 1) + 2
            scene = streaming.scene()
        check_on(self.device, scene=scene.means, camera=cam0.position)
        self.scene = scene
        self.cfg = cfg
        self.slots = slots
        self.viewers_per_scene = viewers_per_scene
        self.num_scenes = slots // viewers_per_scene
        # the static worst case: every viewer of a scene in its own cell
        self.pool_size = viewers_per_scene
        # Dropless allocation: the pool starts at one entry per scene and
        # grows/shrinks with the live pose-cell count in power-of-two
        # buckets (``_resize_pool``); in private mode it stays at one.
        self.pool_cap = 1
        self.window = max(1, cfg.window) if cfg.use_s2 else 1
        self.global_tick = 0
        self.profile_every = profile_every
        self.tiles_x, self.tiles_y = tile_grid(cam0.width, cam0.height)
        self._cam0 = cam0

        # scene-major shared state and slot-major private state.  The pool
        # bookkeeping (shared.pool_cell / pool_tick / pool_refs) and each
        # slot's entry (priv.pool_idx) are host arrays the scheduler owns.
        self.shared: SceneShared
        self.priv: ViewerPrivate
        self.shared, self.priv = init_fleet(
            scene, cfg, cam0, slots, viewers_per_scene=viewers_per_scene,
            pool_size=self.pool_cap)
        self._empty = self.shared.pool[0][0]
        # the cold-start private lane (a copy of the fresh fleet's slot 0)
        self._fresh_lane = privates_at(self.priv, [0])
        self._scene_of = np.arange(slots) // viewers_per_scene
        self._pool_owner = np.full((self.num_scenes, self.pool_cap), -1,
                                   np.int64)
        # occupied slots (admit .. release) and stashed co-resident viewer
        # contexts (slot oversubscription): both hold pool references, so a
        # paced-idle or stashed viewer's sort entry is never reclaimed
        self._resident: set[int] = set()
        self._stash: dict[str, dict] = {}

        # observability: the SessionManager shares its tracer/registry
        self.tracer = obs_trace.NULL
        self.metrics = obs_metrics.Registry()

        self._slot_cams: list[Camera] = [cam0] * slots
        # frames each slot rendered since it last consumed a sort refresh
        # (drives the paced-slot staleness catch-up in _due_scheduled)
        self._frames_since_due = np.zeros((slots,), np.int64)
        self._pending_sort: set[int] = set()   # admitted, not yet sorted
        self.sort_log: list[dict] = []         # per-step sort accounting
        self.last_timing: TickTiming | None = None
        self._pool_entry_bytes = _entry_bytes(self._empty)
        c = self.shared.cache
        self._cache_bytes = sum(x.nbytes for x in (c.tags, c.values, c.age,
                                                   c.clock))

    # -- dropless pool capacity ---------------------------------------------

    def _resize_pool(self, new_cap: int,
                     keep: Optional[list] = None) -> None:
        """Resize the per-scene pool to ``new_cap`` entries.

        ``keep`` (shrink only) lists the entry indices each scene must
        preserve; they compact to a dense prefix in index order.  Growth
        passes ``keep=None`` and pads: old entries keep their indices, new
        entries start free (cell -1, aged tick, zero refs; their payload is
        entry 0's, which nothing reads before a sort overwrites it).  The
        bookkeeping, every slot's ``pool_idx`` and the stashed lane contexts
        move through the same mapping."""
        old = self.pool_cap
        c = self.num_scenes
        sh = self.shared
        perm = np.zeros((c, new_cap), np.int64)
        remap = np.zeros((c, old), np.int64)
        cell = np.full((c, new_cap), -1, np.int64)
        tick = np.full((c, new_cap), -self.window, np.int64)
        owner = np.full((c, new_cap), -1, np.int64)
        refs = np.zeros((c, new_cap), np.int64)
        for ci in range(c):
            kept = (sorted(keep[ci]) if keep is not None
                    else list(range(min(old, new_cap))))
            for j, p in enumerate(kept):
                perm[ci, j] = p
                remap[ci, p] = j
                cell[ci, j] = sh.pool_cell[ci, p]
                tick[ci, j] = sh.pool_tick[ci, p]
                owner[ci, j] = self._pool_owner[ci, p]
                refs[ci, j] = sh.pool_refs[ci, p]
        pool = tuple(tuple(sh.pool[ci][perm[ci, j]] for j in range(new_cap))
                     for ci in range(c))
        self.shared = dataclasses.replace(sh, pool=pool, pool_cell=cell,
                                          pool_tick=tick, pool_refs=refs)
        self.priv = dataclasses.replace(
            self.priv, pool_idx=remap[self._scene_of, self.priv.pool_idx])
        for ctx in self._stash.values():
            ctx['slot_pool'] = int(
                remap[int(self._scene_of[ctx['slot']]), ctx['slot_pool']])
        self._pool_owner = owner
        self.pool_cap = new_cap
        self.metrics.counter('pool.resizes',
                             'sort-pool capacity resizes').inc()
        self.metrics.gauge('pool.capacity',
                           'allocated sort-pool entries per scene'
                           ).set(new_cap)

    def _grow_pool_for(self, groups) -> None:
        """Grow capacity to cover the plan's highest entry index (the
        planner allocates indices past ``pool_cap`` when no free entry
        exists: every live pose cell is routed, none dropped)."""
        need = 1 + max((g.entry for g in groups), default=-1)
        if need > self.pool_cap:
            self._resize_pool(pow2_bucket(need))

    def _keep_entries(self) -> list:
        """Entries a shrink must preserve, per scene: referenced by any
        resident lane (active, paced-idle or stashed), plus entries still
        adoptable (sorted within the window by a still-resident owner)."""
        keep = [set() for _ in range(self.num_scenes)]
        sh = self.shared
        for ci in range(self.num_scenes):
            for p in range(self.pool_cap):
                if sh.pool_refs[ci, p] > 0:
                    keep[ci].add(p)
                elif (int(self._pool_owner[ci, p]) in self._resident
                      and self.global_tick - sh.pool_tick[ci, p]
                      < self.window):
                    keep[ci].add(p)
        return keep

    def _maybe_shrink_pool(self) -> None:
        keep = self._keep_entries()
        used = max((len(k) for k in keep), default=0)
        target = pow2_bucket(used)
        if target < self.pool_cap:
            self._resize_pool(target, keep=keep)

    # -- slot residency / oversubscription ----------------------------------

    def release(self, slot: int) -> None:
        """The manager vacated ``slot``: its pool entry no longer counts as
        referenced, and the bucketed pool may reclaim the capacity."""
        self._resident.discard(slot)
        self._pending_sort.discard(slot)

    def _lane_context(self, slot: int) -> dict:
        """A copy of the slot's viewer context: its private lane (a
        one-slot ``ViewerPrivate``), its last camera (stacked to one) and
        its scheduler bookkeeping."""
        return {
            'slot': int(slot),
            'priv': privates_at(self.priv, [slot]),
            'cam': stack_cameras([self._slot_cams[slot]]),
            'frames_since_due': int(self._frames_since_due[slot]),
            'pending_sort': slot in self._pending_sort,
            'slot_pool': int(self.priv.pool_idx[slot]),
        }

    def _put_lane(self, slot: int, lane: ViewerPrivate,
                  pool_idx: int) -> None:
        """Write a one-slot ``ViewerPrivate`` into ``slot`` in place, with
        ``pool_idx`` as its pool index."""
        self._write_prev_cams([slot], lane.prev_cam)
        self.priv.frame_idx[slot] = lane.frame_idx[0]
        self.priv.cell_id[slot] = lane.cell_id[0]
        self.priv.pool_idx[slot] = pool_idx

    def stash_lane(self, slot: int, key: str) -> None:
        """Park the slot's viewer context under ``key`` so a co-resident
        viewer can interleave into the same physical lane (slot
        oversubscription).  The parked context keeps its pool reference: a
        stashed viewer's sort entry is never reclaimed."""
        self._stash[key] = self._lane_context(slot)
        self._pending_sort.discard(slot)

    def unstash_lane(self, slot: int, key: str) -> None:
        """Swap a parked viewer context back into its physical lane."""
        ctx = self._stash.pop(key)
        if ctx['slot'] != slot:
            raise ValueError(f'stash {key!r} belongs to slot '
                             f'{ctx["slot"]}, not {slot}')
        self._put_lane(slot, ctx['priv'], ctx['slot_pool'])
        self._slot_cams[slot] = camera_at(ctx['cam'], 0)
        self._frames_since_due[slot] = ctx['frames_since_due']
        if ctx['pending_sort']:
            self._pending_sort.add(slot)
        else:
            self._pending_sort.discard(slot)

    def drop_stash(self, key: str) -> None:
        """A stashed viewer was evicted: its parked context (and pool
        reference) goes away."""
        self._stash.pop(key, None)

    # -- per-kernel profiling ----------------------------------------------

    def _profile_kernels(self, shared: SceneShared, priv: ViewerPrivate,
                         cams: Camera, live: torch.Tensor) -> dict:
        """Time the shade's stages on a clone of the pre-shade state: the
        same functions ``batched_shade_phase`` composes on the kernel
        backend, each timed with CUDA events on the card."""
        from ..kernels import ops
        cfg = self.cfg
        tx, ty, gt = self.tiles_x, self.tiles_y, cfg.group_tiles
        chunk = cfg.shade_chunk
        v, c = self.viewers_per_scene, self.num_scenes
        ms, stages = {}, []

        def timed(name, fn):
            t0 = time.perf_counter()
            if self.device.type == 'cuda':
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                ms[name] = start.elapsed_time(end)
            else:
                out = fn()
                ms[name] = (time.perf_counter() - t0) * 1e3
            stages.append((name, t0, time.perf_counter()))
            return out

        feats_b = timed('prep', lambda: ops.pad_features_slots(
            trim_features_slots(batched_prep_features(
                self.scene, shared, priv, cams, cfg, v), tx), chunk))
        st_a = timed('prefix', lambda: ops.rasterize_prefix_slots(
            feats_b, tx, k_record=cfg.k_record, chunk=chunk, live=live))
        cache_f = rc.flatten_scenes(shared.cache)

        def probe():
            ids_v = rc.viewer_major(regroup_slots(st_a.record, tx, ty, gt), v)
            live_v = rc.viewer_major(live[:, None].expand(len(live),
                                                          ids_v.shape[1] // c),
                                     v)
            hit_v = ops.rc_probe_multi(cache_f, ids_v, cfg.cache,
                                       live=live_v)[0]
            hit = ungroup_slots(rc.slot_order(hit_v, c)[..., None], tx, ty,
                                gt)[..., 0]
            return hit, ids_v, hit_v, live_v

        hit, ids_v, hit_v, live_v = timed('lookup', probe)
        miss = ~hit & live[:, None, None]
        colors = timed('resume', lambda: ops.rasterize_resume_compacted_slots(
            feats_b, tx, st_a, miss, t_img=feats_b.ids.shape[1],
            k_record=cfg.k_record, chunk=chunk, bg=cfg.bg))[0]
        timed('insert', lambda: rc.insert_all_groups_multi(
            cache_f, ids_v, rc.viewer_major(regroup_slots(colors, tx, ty, gt),
                                            v),
            ~hit_v & rc.viewer_live(live_v, hit_v.shape), cfg.cache))
        self.tracer.complete('shade.profile', stages[0][1], stages[-1][2])
        for name, t0, t1 in stages:
            self.tracer.complete(f'kernel.{name}', t0, t1, depth=1)
        return ms

    # -- scheduling ---------------------------------------------------------

    def reset(self) -> None:
        """Cold-start every scene and viewer: fresh fleet state, pool
        bookkeeping, tick counter and (streamed) an empty arena."""
        if self._streaming is not None:
            self._streaming.reset()
            self.scene = self._streaming.scene()
        self.pool_cap = 1
        self.shared, self.priv = init_fleet(
            self.scene, self.cfg, self._cam0, self.slots,
            viewers_per_scene=self.viewers_per_scene,
            pool_size=self.pool_cap)
        self._empty = self.shared.pool[0][0]
        self._pool_owner = np.full((self.num_scenes, self.pool_cap), -1,
                                   np.int64)
        self._slot_cams = [self._cam0] * self.slots
        self._frames_since_due[:] = 0
        self._pending_sort.clear()
        self._resident.clear()
        self._stash.clear()
        self.global_tick = 0
        self.sort_log = []
        self.last_timing = None

    def _write_prev_cams(self, slots, cams: Camera) -> None:
        """Write ``cams`` ([len(slots)] stacked) into the given slots of
        ``priv.prev_cam`` in place.  The stacked host copy of the poses is
        dropped rather than patched: the scheduler keys pose cells from the
        cameras a step is given, never from ``prev_cam``."""
        pc = self.priv.prev_cam
        idx = torch.as_tensor(slots, device=pc.position.device)
        for f in ('position', 'quat', 'fx', 'fy', 'cx', 'cy'):
            getattr(pc, f)[idx] = getattr(cams, f)
        self.priv = dataclasses.replace(
            self.priv, prev_cam=dataclasses.replace(pc, host_pose=None))

    def admit(self, slot: int) -> None:
        """Reset ``slot`` to its cold-start state.  In private mode the
        slot's whole scene (cache and pool) cold-starts with it; in shared
        mode only the viewer's private state does: the scene's cache and
        live pool entries persist for the other viewers."""
        if self.viewers_per_scene == 1:
            scene_i = int(self._scene_of[slot])
            sh = self.shared
            cache = sh.cache
            cache.tags[scene_i] = rc.INVALID_TAG
            cache.values[scene_i] = 0.0
            cache.age[scene_i] = 0
            cache.clock[scene_i] = 0
            pool = list(sh.pool)
            pool[scene_i] = (self._empty,) * self.pool_cap
            self.shared = dataclasses.replace(sh, pool=tuple(pool))
            sh.pool_cell[scene_i] = -1
            sh.pool_tick[scene_i] = -self.window
            # pool_refs keep their count until the next dispatch recounts
            # them, as the JAX package's host mirror does
            self._pool_owner[scene_i] = -1
        self._put_lane(slot, self._fresh_lane, 0)
        self._frames_since_due[slot] = 0
        self._resident.add(slot)
        # the slot's camera is only known at the next step(): its
        # sort-on-admit runs there, outside the scheduled cohort
        self._pending_sort.add(slot)

    def quarantine(self, slot: int) -> None:
        """Containment for a poisoned slot: its private state resets to the
        cold-start template, any pool entry it owns is marked stale (owner
        cleared, tick aged out of the window) so no co-located viewer adopts
        it, its stashed co-residents re-sort on their return, and the slot
        re-sorts on its next frame.  In private mode this is a full scene
        cold-start; in shared mode the scene's cache persists (the
        ``isfinite`` insert gate kept non-finite colors out of it)."""
        scene_i = int(self._scene_of[slot])
        if self.viewers_per_scene > 1:
            owned = np.flatnonzero(self._pool_owner[scene_i] == slot)
            self._pool_owner[scene_i, owned] = -1
            self.shared.pool_tick[scene_i, owned] = -self.window
        for ctx in self._stash.values():
            if ctx['slot'] == slot:
                ctx['pending_sort'] = True
        self.admit(slot)
        # the stacked camera batch reads _slot_cams every dispatch: a NaN
        # lane must not linger past containment
        self._slot_cams[slot] = self._cam0

    def _due_scheduled(self, active: set, exclude: set,
                       fsd=None) -> list[int]:
        """Slots due for a scheduled sort refresh this tick: the cohort
        residue (``global_tick % window == slot % window``), plus a
        staleness catch-up for frame-paced viewers: a slot is due when the
        frame it is about to render would otherwise be its ``window``-th
        since the last refresh.  For slots that render every tick the
        residue fires no later than the catch-up could."""
        fsd = self._frames_since_due if fsd is None else fsd
        r = self.global_tick % self.window
        return [i for i in range(self.slots)
                if i in active and i not in exclude
                and (i % self.window == r or fsd[i] >= self.window - 1)]

    def _plan_groups(self, due: list[int], active: set,
                     cells: dict[int, int], slot_pool=None,
                     protect=()) -> list[_SortGroup]:
        """Group the due slots by (scene, pose cell), elect leaders, pick
        pool entries and decide which groups sort.

        Deterministic given (slot -> cell, pool bookkeeping): groups are
        taken in order of their lowest slot; entry allocation prefers the
        entry already holding the cell, then the lowest free entry (refs
        counted over active non-due slots, paced-idle residents and earlier
        groups).  A group adopts without sorting iff its cell's entry is
        fresh (sorted within the window) and owned by a still-active slot
        outside the group that is still in that cell.  Non-due active slots
        of the scene in the same cell ride along onto the group's entry
        (riders do not count as sorted).  Entries of stashed co-resident
        contexts count as referenced too.  When every in-capacity entry is
        referenced, the dynamic pool allocates indices past ``pool_cap``;
        ``_grow_pool_for`` resizes before the sorts land.  ``slot_pool``/
        ``protect`` let ``plan_step`` substitute the entries after lane
        swaps."""
        sh = self.shared
        sp = self.priv.pool_idx if slot_pool is None else slot_pool
        groups: dict[tuple[int, int], list[int]] = {}
        for i in due:
            groups.setdefault((int(self._scene_of[i]), cells[i]),
                              []).append(i)
        rider_pool: dict[tuple[int, int], list[int]] = {}
        for i in sorted(active):
            key = (int(self._scene_of[i]), cells[i])
            if i not in due and key in groups:
                rider_pool.setdefault(key, []).append(i)

        refs = np.zeros((self.num_scenes, self.pool_cap), np.int64)
        for i in active:
            if i not in due and (int(self._scene_of[i]), cells[i]) \
                    not in groups:
                refs[self._scene_of[i], sp[i]] += 1
        self._count_held(refs, sp, active)
        for scene_i, p in protect:
            refs[scene_i, p] += 1
        claimed: set[tuple[int, int]] = set()
        next_new: dict[int, int] = {}
        planned = []
        for (scene_i, cell), members in sorted(groups.items(),
                                               key=lambda kv: min(kv[1])):
            leader = min(members)
            riders = tuple(rider_pool.get((scene_i, cell), ()))
            # an entry still tagged with this cell is reusable only if no
            # earlier group claimed it this tick
            held = [int(p)
                    for p in np.flatnonzero(sh.pool_cell[scene_i] == cell)
                    if (scene_i, int(p)) not in claimed]
            entry = held[0] if held else -1
            if entry >= 0:
                owner = int(self._pool_owner[scene_i, entry])
                fresh = (self.global_tick - sh.pool_tick[scene_i, entry]
                         < self.window)
                owner_ok = (owner in active and owner not in members
                            and cells.get(owner) == cell)
                if fresh and owner_ok:
                    planned.append(_SortGroup(scene_i, cell, leader,
                                              tuple(members), riders,
                                              entry, False))
                    claimed.add((scene_i, entry))
                    refs[scene_i, entry] += len(members) + len(riders)
                    continue
            if entry < 0:
                free = [p for p in range(self.pool_cap)
                        if refs[scene_i, p] == 0
                        and (scene_i, p) not in claimed]
                if free:
                    entry = free[0]
                else:
                    # private mode always finds its one entry free; a shared
                    # scene allocates an index past capacity (dropless)
                    entry = next_new.get(scene_i, self.pool_cap)
                    next_new[scene_i] = entry + 1
            planned.append(_SortGroup(scene_i, cell, leader, tuple(members),
                                      riders, entry, True))
            claimed.add((scene_i, entry))
            if entry < self.pool_cap:
                refs[scene_i, entry] += len(members) + len(riders)
        return planned

    def _run_sorts(self, cam_b: Camera, groups: list[_SortGroup]) -> None:
        """Run the sorting groups' leader sorts and put each entry in its
        scene's pool."""
        leaders = [g.leader for g in groups]
        entries = batched_sort_phase(self.scene, privates_at(self.priv, leaders),
                                     camera_at(cam_b, torch.as_tensor(leaders)),
                                     self.cfg)
        pool = [list(p) for p in self.shared.pool]
        for g, entry in zip(groups, entries):
            pool[g.scene][g.entry] = entry
        self.shared = dataclasses.replace(
            self.shared, pool=tuple(tuple(p) for p in pool))
        for g in groups:
            self.shared.pool_cell[g.scene, g.entry] = g.cell
            self.shared.pool_tick[g.scene, g.entry] = self.global_tick
            self._pool_owner[g.scene, g.entry] = g.leader

    def _apply_assignments(self, groups: list[_SortGroup],
                           active: set) -> None:
        """Point every group member at its entry and refresh the pool
        refcounts."""
        for g in groups:
            for m in g.members + g.riders:
                self.priv.pool_idx[m] = g.entry
                self.priv.cell_id[m] = g.cell
        refs = np.zeros((self.num_scenes, self.pool_cap), np.int64)
        sp = self.priv.pool_idx
        for i in active:
            refs[self._scene_of[i], sp[i]] += 1
        self._count_held(refs, sp, active)
        self.shared = dataclasses.replace(self.shared, pool_refs=refs)

    def _count_held(self, refs: np.ndarray, sp, active: set) -> None:
        """Add to ``refs`` the entries held across idle ticks: by paced-idle
        residents (slot entries ``sp``) and by stashed co-resident
        contexts."""
        for i in self._resident:
            if i not in active and i not in self._pending_sort:
                refs[self._scene_of[i], sp[i]] += 1
        for ctx in self._stash.values():
            if not ctx['pending_sort']:
                refs[self._scene_of[ctx['slot']], ctx['slot_pool']] += 1

    def _slot_cell_key(self, slot: int, cam: Camera) -> int:
        """Pose-cell key for a slot rendering ``cam``.  In private mode the
        slot id keys its own singleton group.  The key is computed from the
        camera's host copy of its pose (``Camera.host_pose``), so planning
        never waits for the device."""
        if self.viewers_per_scene == 1:
            return slot
        return posecell.pose_cell_key(cam)

    def plan_step(self, cams: dict[int, Camera], pending_admits=(),
                  lane_swaps=None) -> _StepPlan:
        """Pure host planning for a coming ``step(cams)``: pose-cell keys,
        the sort-on-admit set, the due cohort and the sort groups.  Reads
        only host state and mutates nothing.  ``pending_admits`` names
        slots whose ``admit()`` is planned but not yet applied.
        ``lane_swaps`` maps slot -> stash key for oversubscribed lanes the
        manager will swap before dispatch: the plan takes the incoming
        context's pending flag, cadence and entry in place of the slot's,
        and protects the outgoing occupant's entry (it is stashed, not
        released) from the free-entry search.

        With streaming, residency is planned first: slots stalled on a
        missing chunk drop out of the tick (no render, no sort, cursor
        retried), so the scheduling sees only the slots that will run.
        Pending admits are named so that their cold-start loads are exempt
        from the per-tick load budget."""
        stream = None
        if self._streaming is not None and cams:
            admit_guess = ((set(self._pending_sort) | set(pending_admits))
                           & set(cams))
            stream = self._streaming.plan(self.global_tick, cams,
                                          admit_guess)
            if stream.stalled:
                cams = {s: c for s, c in cams.items()
                        if s not in stream.stalled}
        active = set(cams)
        if not cams or not self.cfg.use_s2:
            return _StepPlan(frozenset(active), (), (), (), stream)
        cells = {i: self._slot_cell_key(i, cams[i]) for i in active}
        pending = set(self._pending_sort)
        slot_pool = self.priv.pool_idx
        fsd = self._frames_since_due
        protect = []
        if lane_swaps:
            slot_pool = slot_pool.copy()
            fsd = fsd.copy()
            for slot, key in lane_swaps.items():
                ctx = self._stash[key]
                if slot not in self._pending_sort:
                    protect.append((int(self._scene_of[slot]),
                                    int(self.priv.pool_idx[slot])))
                pending.discard(slot)
                if ctx['pending_sort']:
                    pending.add(slot)
                slot_pool[slot] = ctx['slot_pool']
                fsd[slot] = ctx['frames_since_due']
        admits = sorted((pending | set(pending_admits)) & active)
        sched = self._due_scheduled(active, exclude=set(admits), fsd=fsd)
        due = sorted(set(admits) | set(sched))
        groups = self._plan_groups(due, active, cells, slot_pool=slot_pool,
                                   protect=protect)
        return _StepPlan(active=frozenset(active), admits=tuple(admits),
                         due=tuple(due), groups=tuple(groups), stream=stream)

    def _apply_stream(self, stream) -> None:
        """Execute a residency plan (evictions, loads, render mask) and take
        the streamed scene for this tick's shade.  The manager publishes
        through this stepper's registry and tracer, re-pointed every call
        because the session installs its tracer after construction."""
        mgr = self._streaming
        mgr.metrics = self.metrics
        mgr.tracer = self.tracer
        mgr.apply(stream)
        if mgr.dirty:
            self.scene = mgr.scene()

    def step_dispatch(self, cams: dict[int, Camera],
                      plan: Optional[_StepPlan] = None):
        """Host scheduling and device dispatch for one step.  Returns an
        ``_InFlight`` handle; all host-side mutations (sort bookkeeping,
        ``global_tick``, ``sort_log``) are complete when this returns.
        ``step_finish`` waits for the device."""
        if not cams:
            return None
        for cam in cams.values():
            check_on(self.device, camera=cam.position)
        with self.tracer.span('step_dispatch', tick=self.global_tick,
                              slots=len(cams)), torch.no_grad():
            return self._dispatch(cams, plan)

    def _record_sorts(self, plan: _StepPlan, groups, sorting) -> tuple:
        admit_set = set(plan.admits)
        n_admit = sum(1 for g in sorting if g.leader in admit_set)
        n_sched = len(sorting) - n_admit
        n_joined = (sum(len(g.members) for g in groups if not g.sorts)
                    + sum(len(g.riders) for g in groups))
        # executions vs adoptions per (scene, pose cell)
        for g in groups:
            adopted = len(g.members) - (1 if g.sorts else 0)
            if g.sorts:
                self.metrics.counter('sort.executed', 'speculative sorts run',
                                     scene=g.scene, cell=g.cell).inc()
            if adopted:
                self.metrics.counter(
                    'sort.adopted', 'due slots adopting a leader sort',
                    scene=g.scene, cell=g.cell).inc(adopted)
            if g.riders:
                self.metrics.counter(
                    'sort.riders',
                    'non-due slots consolidated onto a fresh entry',
                    scene=g.scene, cell=g.cell).inc(len(g.riders))
        return n_sched, n_admit, n_joined

    def _dispatch(self, cams: dict[int, Camera], plan: Optional[_StepPlan]):
        if plan is None:
            plan = self.plan_step(cams)
        if plan.stream is not None:
            self._apply_stream(plan.stream)
            if plan.stream.stalled:
                # a stalled slot renders nothing this tick: no output, so
                # its cursor stays and the frame retries next tick
                cams = {s: c for s, c in cams.items()
                        if s not in plan.stream.stalled}
            if not cams:
                # every requested slot stalled: the loads above still ran,
                # so the retried tick makes progress
                self.global_tick += 1
                self.sort_log.append({'scheduled': 0, 'admit': 0,
                                      'joined': 0})
                return None
        for slot, cam in cams.items():
            self._slot_cams[slot] = cam
        cam_b = stack_cameras(self._slot_cams)
        active = set(cams)

        t0 = time.perf_counter()
        n_admit = n_sched = n_joined = 0
        if self.cfg.use_s2:
            groups = list(plan.groups)
            sorting = [g for g in groups if g.sorts]
            # grow BEFORE the sorts land in the pool
            self._grow_pool_for(groups)
            if sorting:
                self._run_sorts(cam_b, sorting)
            self._apply_assignments(groups, active)
            self._pending_sort -= active
            # shrink AFTER the refcounts are fresh
            self._maybe_shrink_pool()
            n_sched, n_admit, n_joined = self._record_sorts(plan, groups,
                                                            sorting)
            # ``sorted_this_frame`` flags every DUE slot (it renders from a
            # sort refreshed for its cell this window, run or adopted);
            # ``sorted_slots``/sort_log count only the sorts RUN
            sorted_set = set(plan.due)
            for i in active:
                self._frames_since_due[i] = (0 if i in sorted_set
                                             else self._frames_since_due[i]
                                             + 1)
            if sorting:
                _sync(self.device)
        else:
            # no S^2: every active lane sorts inside its shade
            self._pending_sort -= active
            sorted_set = active
            n_sched = len(sorted_set)
            self.metrics.counter(
                'sort.executed',
                'per-lane sorts (no-S2 baseline)').inc(n_sched)
        sort_s = time.perf_counter() - t0
        if n_sched + n_admit:
            self.tracer.complete('sort', t0, t0 + sort_s,
                                 tick=self.global_tick,
                                 executed=n_sched + n_admit)

        sorted_mask = torch.tensor(
            [1.0 if i in sorted_set else 0.0 for i in range(self.slots)],
            dtype=torch.float32, device=self.device)
        active_full = torch.tensor([i in active for i in range(self.slots)],
                                   device=self.device)
        profile = None
        if (self.profile_every > 0 and self.cfg.backend == 'kernel'
                and self.cfg.use_rc
                and self.global_tick % self.profile_every == 0):
            # the tick writes results into the fleet's cache in place:
            # profile on a clone of the pre-shade state
            c = self.shared.cache
            prof_shared = dataclasses.replace(self.shared, cache=rc.CacheState(
                c.tags.clone(), c.values.clone(), c.age.clone(),
                c.clock.clone()))
            prof_priv = dataclasses.replace(self.priv,
                                            pool_idx=self.priv.pool_idx.copy())
            profile = (prof_shared, prof_priv, cam_b, active_full)

        t1 = time.perf_counter()
        images, stats, pos = self._shade(cam_b, sorted_mask, active_full,
                                         active)
        self.global_tick += 1
        self.sort_log.append({'scheduled': n_sched, 'admit': n_admit,
                              'joined': n_joined})
        return _InFlight(cams=cams, images=images, stats=stats, pos=pos,
                         t0=t0, t1=t1, sort_s=sort_s, n_sched=n_sched,
                         n_admit=n_admit, profile=profile,
                         tick=self.global_tick - 1)

    def _shade(self, cam_b: Camera, sorted_mask, active_full, active: set):
        """One tick's shade: the full batch, or a compacted sub-batch whose
        results are written back in place.  Returns (images, stats, slot ->
        lane)."""
        v = self.viewers_per_scene
        active_scenes = sorted({int(self._scene_of[i]) for i in active})
        per_scene = {c: [i for i in range(c * v, (c + 1) * v) if i in active]
                     for c in active_scenes}
        # within-scene lane width: the pow2 bucket of the busiest active
        # scene's live lane count
        lanes = (pow2_bucket(max(len(s) for s in per_scene.values()), cap=v)
                 if v > 1 else 1)
        if lanes == v and len(active_scenes) == self.num_scenes:
            # every scene live at full lane width: no gather (idle slots
            # inside a scene still ride with active=False)
            self.shared, self.priv, images, stats = batched_shade_phase(
                self.scene, self.shared, self.priv, cam_b, sorted_mask,
                active_full, self.cfg, v)
            return images, stats, {slot: slot for slot in active}
        bucket = pow2_bucket(len(active_scenes), cap=self.num_scenes)
        pad = bucket - len(active_scenes)
        scenes_g = active_scenes + [active_scenes[0]] * pad
        scene_tgt = active_scenes
        if lanes == v:
            # idle-scene compaction: shade only the active scene blocks,
            # padded to a power-of-two bucket of scenes
            slots_g = [c * v + j for c in scenes_g for j in range(v)]
            slot_tgt = ([c * v + j for c in active_scenes for j in range(v)]
                        + [-1] * (pad * v))
            act = [i < len(active_scenes) * v and slots_g[i] in active
                   for i in range(bucket * v)]
        else:
            # within-scene lane compaction: each active scene's live lanes,
            # padded to ``lanes`` with inert duplicates; idle lanes of
            # active scenes are not shaded (their skipped update would only
            # bump frame_idx, read solely as == 0, and rewrite prev_cam
            # with the value it holds)
            slots_g, slot_tgt = [], []
            for c in active_scenes:
                live = per_scene[c]
                fill = lanes - len(live)
                slots_g += live + [live[0]] * fill
                slot_tgt += live + [-1] * fill
            for _ in range(pad):
                slots_g += [slots_g[0]] * lanes
                slot_tgt += [-1] * lanes
            act = [t >= 0 for t in slot_tgt]
        sh, pv = self.shared, self.priv
        idx = torch.as_tensor(slots_g)
        scene_idx = torch.as_tensor(scenes_g, device=self.device)
        sub_shared = dataclasses.replace(
            sh, cache=_cache_rows(sh.cache, scene_idx),
            pool=tuple(sh.pool[c] for c in scenes_g),
            pool_cell=sh.pool_cell[scenes_g],
            pool_refs=sh.pool_refs[scenes_g],
            pool_tick=sh.pool_tick[scenes_g])
        new_sh, new_pv, images, stats = batched_shade_phase(
            self.scene, sub_shared, privates_at(pv, slots_g),
            camera_at(cam_b, idx),
            sorted_mask[idx.to(self.device)],
            torch.tensor(act, device=self.device), self.cfg, lanes)
        # write the real lanes back in place; padding lanes are dropped
        # first, so every target index is unique
        n = len(scene_tgt)
        tgt_scenes = torch.as_tensor(scene_tgt, device=self.device)
        for full, part in zip((sh.cache.tags, sh.cache.values, sh.cache.age,
                               sh.cache.clock),
                              (new_sh.cache.tags, new_sh.cache.values,
                               new_sh.cache.age, new_sh.cache.clock)):
            full[tgt_scenes] = part[:n]
        src = [j for j, t in enumerate(slot_tgt) if t >= 0]
        tgt = [slot_tgt[j] for j in src]
        self._write_prev_cams(tgt, camera_at(new_pv.prev_cam,
                                             torch.as_tensor(src)))
        self.priv.frame_idx[tgt] = new_pv.frame_idx[src]
        return images, stats, dict(zip(tgt, src))

    def step_finish(self, infl) -> dict:
        """Wait for a dispatched step's device work and assemble the
        per-slot outputs and the tick timing."""
        if infl is None:
            return {}
        _sync(self.device)
        t2 = time.perf_counter()
        self.tracer.complete('shade', infl.t1, t2, tick=infl.tick,
                             slots=len(infl.cams))
        kernel_ms = None
        if infl.profile is not None:
            with torch.no_grad():
                kernel_ms = self._profile_kernels(*infl.profile)
        timing = TickTiming(latency_s=t2 - infl.t0,
                            sort_ms=infl.sort_s * 1e3,
                            shade_ms=(t2 - infl.t1) * 1e3,
                            sorted_slots=infl.n_sched + infl.n_admit,
                            kernel_ms=kernel_ms)
        self.last_timing = timing
        # every rider of the batch waited for the whole tick
        return {slot: (infl.images[infl.pos[slot]],
                       stats_at(infl.stats, infl.pos[slot]), timing)
                for slot in infl.cams}

    def step(self, cams: dict[int, Camera],
             plan: Optional[_StepPlan] = None) -> dict:
        return self.step_finish(self.step_dispatch(cams, plan))

    # -- telemetry ----------------------------------------------------------

    def state_metrics(self) -> dict:
        """Occupancy and state-memory footprint of the shared state:
        ``*_bytes`` charge only entries with live referencing viewers,
        ``*_alloc_bytes`` what the pool allocates now (``pool_cap`` entries
        per scene), ``*_reserved_bytes`` the static worst case (one entry
        per viewer of a scene)."""
        live = int((self.shared.pool_refs > 0).sum())
        pool_bytes = live * self._pool_entry_bytes
        pool_alloc = (self.num_scenes * self.pool_cap
                      * self._pool_entry_bytes)
        pool_reserved = (self.num_scenes * self.pool_size
                         * self._pool_entry_bytes)
        m = {
            # not synced here: the rollup reads it after the timed loop
            'occupancy': rc.occupancy(self.shared.cache),
            'sort_pool_live': live,
            'sort_pool_total': self.num_scenes * self.pool_cap,
            'sort_pool_bytes': pool_bytes,
            'sort_pool_alloc_bytes': pool_alloc,
            'sort_pool_reserved_bytes': pool_reserved,
            'cache_bytes': self._cache_bytes,
            'state_bytes': pool_bytes + self._cache_bytes,
            'state_alloc_bytes': pool_alloc + self._cache_bytes,
            'state_reserved_bytes': pool_reserved + self._cache_bytes,
        }
        if self._streaming is not None:
            mgr = self._streaming
            cnt = mgr.counters()
            m.update({
                'stream_resident_bytes': mgr.resident_bytes,
                'stream_arena_bytes': mgr.arena_bytes,
                'stream_full_bytes': mgr.chunked.scene_bytes,
                'stream_stalls': cnt['stalls'],
                'stream_loads': cnt['loads'],
                'stream_prefetch_hits': cnt['prefetch_hits'],
                'stream_evictions': cnt['evictions'],
            })
        self.metrics.gauge(
            'state.alloc_bytes',
            'device bytes backing live serving state').set(
                float(m['state_alloc_bytes']))
        self.metrics.gauge(
            'state.reserved_bytes',
            'worst-case static-pool serving state bytes').set(
                float(m['state_reserved_bytes']))
        return m

    # -- checkpoint/restore --------------------------------------------------

    def _state_arrays(self, copy: bool) -> dict:
        arrays = {
            'cache': _cache_arrays(self.shared.cache, copy),
            'pool': tuple(tuple(_entry_arrays(e, copy) for e in row)
                          for row in self.shared.pool),
            'priv': _priv_arrays(self.priv, copy),
            'slot_cams': camera_arrays(stack_cameras(self._slot_cams),
                                       copy=False),
        }
        if self._stash:
            arrays['stash'] = {k: {'priv': _priv_arrays(ctx['priv'], copy),
                                   'cam': camera_arrays(ctx['cam'], copy)}
                               for k, ctx in self._stash.items()}
        if self._streaming is not None:
            arrays['stream'] = self._streaming.state_dict(copy)[0]
        return arrays

    def state_dict(self, copy: bool = True) -> tuple:
        """``(arrays, meta)``: everything a bit-identical resume needs,
        taken at a tick boundary.  ``arrays`` is nested dicts of tensors and
        numpy arrays (the caches, every pool entry, the private lanes
        without their pool index, the slots' last cameras and the stashed
        lane contexts, and a streamed scene's arena); ``meta`` holds the
        scheduler's bookkeeping (and the residency mirrors under
        ``'stream'``) as JSON-able values, under the JAX package's keys.  Every tensor is a
        clone, since the next tick writes the live state in place; with
        ``copy=False`` the tensors are the live ones, for a caller that
        copies them before the next tick (``CheckpointManager.save``)."""
        sh = self.shared
        meta = {
            'global_tick': int(self.global_tick),
            'pool_cap': int(self.pool_cap),
            'pool_cell': sh.pool_cell.tolist(),
            'pool_tick': sh.pool_tick.tolist(),
            'pool_owner': self._pool_owner.tolist(),
            'slot_pool': self.priv.pool_idx.tolist(),
            'refs': sh.pool_refs.tolist(),
            'frames_since_due': self._frames_since_due.tolist(),
            'pending_sort': sorted(int(i) for i in self._pending_sort),
            'resident': sorted(int(i) for i in self._resident),
            'stash': {k: {'slot': int(ctx['slot']),
                          'frames_since_due': int(ctx['frames_since_due']),
                          'pending_sort': bool(ctx['pending_sort']),
                          'slot_pool': int(ctx['slot_pool'])}
                      for k, ctx in self._stash.items()},
        }
        if self._streaming is not None:
            meta['stream'] = self._streaming.state_dict(copy=False)[1]
        return self._state_arrays(copy), meta

    def _priv_from(self, arrays: dict, pool_idx) -> ViewerPrivate:
        return ViewerPrivate(
            prev_cam=camera_from_arrays(self._cam0, arrays['prev_cam'],
                                        self.device),
            frame_idx=np.array(arrays['frame_idx'], np.int64),
            cell_id=np.array(arrays['cell_id'], np.int64),
            pool_idx=np.array(pool_idx, np.int64))

    def load_state(self, arrays, meta: dict) -> None:
        """Restore a ``state_dict`` snapshot (or ``interop``'s form of the
        JAX package's).  The tensors are copied onto the stepper's device,
        so the next tick never writes into the caller's arrays; the pool
        capacity is the snapshot's."""
        dev = self.device
        self.pool_cap = int(meta['pool_cap'])
        self.shared = SceneShared(
            cache=_cache_from(arrays['cache'], dev),
            pool=tuple(tuple(_entry_from(self._empty, e, dev) for e in row)
                       for row in arrays['pool']),
            pool_cell=np.array(meta['pool_cell'], np.int64),
            pool_refs=np.array(meta['refs'], np.int64),
            pool_tick=np.array(meta['pool_tick'], np.int64))
        self.priv = self._priv_from(arrays['priv'], meta['slot_pool'])
        cam_b = camera_from_arrays(self._cam0, arrays['slot_cams'], dev)
        self._slot_cams = [camera_at(cam_b, i) for i in range(self.slots)]
        self.global_tick = int(meta['global_tick'])
        self._pool_owner = np.array(meta['pool_owner'], np.int64)
        self._frames_since_due = np.array(meta['frames_since_due'], np.int64)
        self._pending_sort = {int(i) for i in meta['pending_sort']}
        self._resident = {int(i) for i in meta['resident']}
        self._stash = {}
        for k, sm in meta['stash'].items():
            sa = arrays['stash'][k]
            self._stash[k] = {
                'slot': int(sm['slot']),
                'priv': self._priv_from(sa['priv'], [sm['slot_pool']]),
                'cam': camera_from_arrays(self._cam0, sa['cam'], dev),
                'frames_since_due': int(sm['frames_since_due']),
                'pending_sort': bool(sm['pending_sort']),
                'slot_pool': int(sm['slot_pool']),
            }
        if self._streaming is not None and 'stream' in meta:
            self._streaming.load_state(arrays['stream'], meta['stream'])
            self.scene = self._streaming.scene()

    def state_template(self, meta: dict) -> dict:
        """An arrays tree shaped like a snapshot whose ``meta`` is given,
        without touching the live state: a crashed run may have saved at
        another pool capacity, or with stashed lanes.  Only shapes and
        structure matter; the values are never read."""
        arrays = self._state_arrays(copy=False)
        empty = _entry_arrays(self._empty, copy=False)
        arrays['pool'] = tuple((empty,) * int(meta['pool_cap'])
                               for _ in range(self.num_scenes))
        arrays.pop('stash', None)
        if meta['stash']:
            lane = {'priv': _priv_arrays(privates_at(self.priv, [0]), False),
                    'cam': camera_arrays(stack_cameras([self._cam0]), False)}
            arrays['stash'] = {k: lane for k in meta['stash']}
        arrays.pop('stream', None)
        if self._streaming is not None and 'stream' in meta:
            arrays['stream'] = self._streaming.state_template()
        return arrays

    # -- viewer extraction / injection ----------------------------------------

    def extract_viewer(self, slot: int, with_scene: bool = False) -> dict:
        """A copy of one viewer's lane for re-admission on another stepper:
        its private lane, last camera and cadence, and with ``with_scene``
        (private mode only) its whole scene block (cache, pool entries and
        their bookkeeping), a warm move.  A scene-carry payload is valid
        only for an aligned restore (the same slot on a stepper at the same
        ``global_tick``): ``pool_owner`` holds slot ids and ``pool_tick``
        absolute ticks."""
        ctx = self._lane_context(slot)
        payload = {'priv': ctx['priv'], 'cam': ctx['cam'],
                   'frames_since_due': ctx['frames_since_due'],
                   'pending_sort': ctx['pending_sort'],
                   'shared': None, 'pool_rows': None}
        if with_scene:
            if self.viewers_per_scene != 1:
                raise ValueError('scene-carry extraction needs a private '
                                 'scene block (viewers_per_scene == 1)')
            scene_i = int(self._scene_of[slot])
            sh = self.shared
            payload['shared'] = {
                'cache': rc.CacheState(*(getattr(sh.cache, f)[scene_i].clone()
                                         for f in _CACHE_FIELDS)),
                'pool': sh.pool[scene_i]}
            payload['pool_rows'] = {
                'pool_cell': sh.pool_cell[scene_i].copy(),
                'pool_tick': sh.pool_tick[scene_i].copy(),
                'pool_owner': self._pool_owner[scene_i].copy(),
                'slot_pool': ctx['slot_pool'],
                'refs': sh.pool_refs[scene_i].copy(),
            }
        return payload

    def restore_viewer(self, slot: int, payload: dict) -> None:
        """Re-admit an ``extract_viewer`` payload into ``slot``: a
        scene-carry payload restores the scene block and its bookkeeping
        (bit-identical continuation under the alignment contract above); a
        cold one admits the slot (fresh scene, sort-on-admit queued) and
        then writes the private lane, so the viewer resumes its trajectory
        against a cold cache.  A payload extracted on another card is
        moved to this stepper's device first."""
        payload = _payload_on(payload, self.device)
        if payload.get('shared') is not None:
            if self.viewers_per_scene != 1:
                raise ValueError('scene-carry restore needs a private '
                                 'scene block (viewers_per_scene == 1)')
            scene_i = int(self._scene_of[slot])
            sh = self.shared
            block = payload['shared']
            for f in _CACHE_FIELDS:
                getattr(sh.cache, f)[scene_i] = getattr(block['cache'], f)
            pool = list(sh.pool)
            pool[scene_i] = tuple(block['pool'])
            self.shared = dataclasses.replace(sh, pool=tuple(pool))
            rows = payload['pool_rows']
            sh.pool_cell[scene_i] = rows['pool_cell']
            sh.pool_tick[scene_i] = rows['pool_tick']
            sh.pool_refs[scene_i] = rows['refs']
            self._pool_owner[scene_i] = rows['pool_owner']
            self._put_lane(slot, payload['priv'], rows['slot_pool'])
            self._frames_since_due[slot] = payload['frames_since_due']
            if payload['pending_sort']:
                self._pending_sort.add(slot)
            else:
                self._pending_sort.discard(slot)
        else:
            self.admit(slot)
            self._put_lane(slot, payload['priv'], 0)
        self._slot_cams[slot] = camera_at(payload['cam'], 0)


class SequentialStepper:
    """Reference engine: one ``render_step`` per active slot, per-viewer
    sort cadence (``frame_idx % window``), fully private state (each slot
    carries its own scene: cache and a pool of one)."""

    viewers_per_scene = 1

    def __init__(self, scene: GaussianScene, cfg: LuminaConfig,
                 cam0: Camera, slots: int, *, device=None):
        self.device = resolve_device(device)
        check_on(self.device, scene=scene.means, camera=cam0.position)
        self.scene = scene
        self.cfg = cfg
        self.slots = slots
        self._cam0 = cam0
        # the step returns new state and never writes into its input, so
        # slots may start from one cold-start template
        self._fresh = init_viewer_state(scene, cfg, cam0)
        self._states = [self._fresh] * slots
        self.tracer = obs_trace.NULL
        self.metrics = obs_metrics.Registry()
        self.sort_log: list[dict] = []
        self.last_timing: TickTiming | None = None
        self._last_active = 0
        c = self._fresh.cache
        self._cache_bytes = sum(x.nbytes for x in (c.tags, c.values, c.age,
                                                   c.clock))
        self._empty = empty_sort_shared(scene, cam0, margin=cfg.margin,
                                        capacity=cfg.capacity)
        self._pool_entry_bytes = _entry_bytes(self._empty)

    def admit(self, slot: int) -> None:
        self._states[slot] = self._fresh

    def release(self, slot: int) -> None:
        """No dynamic capacity to reclaim on the static engine."""

    def quarantine(self, slot: int) -> None:
        """Containment on the private engine is a full cold-start: every
        piece of the slot's state (cache included) is its own."""
        self.admit(slot)

    def state_dict(self, copy: bool = True) -> tuple:
        """``(arrays, meta)`` (see ``BatchedStepper.state_dict``): each
        slot's cache, sort entry (the zero entry before its first sort, which
        its first frame overwrites), entry tick, previous camera and frame
        counter; no host bookkeeping to carry."""
        arrays = {}
        for i, st in enumerate(self._states):
            sh, v = st.scene_shared, st.viewer
            entry = sh.pool[0] if sh.pool[0] is not None else self._empty
            arrays[f'slot{i}'] = {
                'cache': _cache_arrays(sh.cache, copy),
                'entry': _entry_arrays(entry, copy),
                'pool_tick': np.array(sh.pool_tick[0], np.int64),
                'prev_cam': camera_arrays(v.prev_cam, copy),
                'frame_idx': np.array(v.frame_idx, np.int64)}
        return arrays, {}

    def load_state(self, arrays, meta: dict) -> None:
        del meta
        dev = self.device
        self._states = []
        for i in range(self.slots):
            a = arrays[f'slot{i}']
            shared = dataclasses.replace(
                self._fresh.scene_shared, cache=_cache_from(a['cache'], dev),
                pool=(_entry_from(self._empty, a['entry'], dev),),
                pool_tick=(int(a['pool_tick']),))
            viewer = dataclasses.replace(
                self._fresh.viewer, frame_idx=int(a['frame_idx']),
                prev_cam=camera_from_arrays(self._cam0, a['prev_cam'], dev))
            self._states.append(ViewerState(scene_shared=shared,
                                            viewer=viewer))

    def reset(self) -> None:
        """Cold-start every slot."""
        self._states = [self._fresh] * self.slots
        self.sort_log = []
        self.last_timing = None
        self._last_active = 0

    def step_dispatch(self, cams: dict[int, Camera], plan=None):
        """Nothing dispatches ahead on the sequential engine: each slot's
        step waits for its own latency attribution, so the whole tick runs
        inside ``step_finish``."""
        del plan
        return cams

    def step_finish(self, cams) -> dict:
        return self.step(cams) if cams else {}

    def step(self, cams: dict[int, Camera], plan=None) -> dict:
        del plan   # host sort planning is a batched-engine concept
        out = {}
        sorts = 0
        t_start = time.perf_counter()
        for slot, cam in cams.items():
            check_on(self.device, camera=cam.position)
            t0 = time.perf_counter()
            self._states[slot], image, stats = render_step(
                self.scene, self._states[slot], cam, self.cfg)
            _sync(self.device)
            t_done = time.perf_counter()
            dt = t_done - t0
            self.tracer.complete('render_step', t0, t_done, slot=slot)
            sorted_flag = int(float(stats.sorted_this_frame))
            sorts += sorted_flag
            # the fused reference step attributes its whole latency to shade
            out[slot] = (image, stats,
                         TickTiming(latency_s=dt, sort_ms=0.0,
                                    shade_ms=dt * 1e3,
                                    sorted_slots=sorted_flag))
        self.sort_log.append({'scheduled': sorts, 'admit': 0, 'joined': 0})
        if sorts:
            self.metrics.counter('sort.executed',
                                 'per-viewer cadence sorts').inc(sorts)
        self.last_timing = TickTiming(
            latency_s=time.perf_counter() - t_start, sort_ms=0.0,
            shade_ms=(time.perf_counter() - t_start) * 1e3,
            sorted_slots=sorts)
        self._last_active = len(cams)
        return out

    def state_metrics(self) -> dict:
        """Private-state footprint: every occupied slot holds a full sort
        entry and a full cache; the engine allocates all ``slots`` copies."""
        live = self._last_active
        pool_bytes = live * self._pool_entry_bytes
        per_slot = self._pool_entry_bytes + self._cache_bytes
        return {
            'sort_pool_live': live,
            'sort_pool_total': self.slots,
            'sort_pool_bytes': pool_bytes,
            'sort_pool_alloc_bytes': self._pool_entry_bytes * self.slots,
            'sort_pool_reserved_bytes': self._pool_entry_bytes * self.slots,
            'cache_bytes': self._cache_bytes * live,
            'state_bytes': pool_bytes + self._cache_bytes * live,
            'state_alloc_bytes': per_slot * self.slots,
            'state_reserved_bytes': per_slot * self.slots,
        }
