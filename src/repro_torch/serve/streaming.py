"""Streaming scene residency: page pose-cell chunks through a device arena.

Large scenes do not fit on the device.  ``ResidencyManager`` owns a
fixed-size device **arena** of ``arena_slots`` chunk frames (sized from a
byte budget) and pages the host-side ``ChunkedScene`` chunks in and out of
it, driven by where the live cameras are:

* chunks within ``near_radius`` grid cells (Chebyshev, the ``core/posecell``
  ``floor(p / cell_size)`` quantization) of any active camera are held at
  **FULL** level; within ``lod_radius`` at **LOD** level, the chunk's
  significance prefix (``data.scenes.level_rows``); beyond that a chunk
  need not be resident at all;
* the render mask per chunk is ``min(required_rows, loaded_rows)``.  When
  nothing stalls the mask equals the requirement, a pure function of the
  camera trajectory, so the effective scene (and every rendered frame) is
  bit-identical across arena budgets, fully resident included;
* a chunk some camera requires beyond its loaded rows is a **miss**: the
  load is scheduled, and if it cannot complete this tick (the per-tick load
  budget ``max_loads_per_tick``; demand of a slot admitted this tick is
  exempt, so cold starts never stall) only the missing viewers' slots stall
  (``stream.stalls``): the stepper drops just those slots from the tick,
  and their cursors retry the same frame next tick;
* when even the **union** of the live working sets exceeds the arena, slots
  reserve capacity in a priority order that rotates every ``grace_ticks +
  2`` ticks: the leading slots win the epoch, the denied slots stall and
  stop requiring their chunks, which age past the grace window and free
  their frames for the next epoch's leaders, so an oversized fleet
  timeshares the arena instead of livelocking.  A single slot whose own
  requirement exceeds the arena can never render and raises at once;
* **prefetch**: with spare load budget the manager pulls the next ring in
  (FULL at ``near_radius + 1``, LOD at ``lod_radius + 1``), so a camera
  drifting into a new cell finds its chunks warm (``stream.prefetch_hits``).
  The threaded driver's worker plans it, with the rest of tick t+1;
* **eviction** frees arena frames only for chunks unrequired for at least
  ``grace_ticks`` (sort window + slack): a stale sorted tile list may still
  gather an evicted chunk's lanes, and the grace period outlives every such
  list, while the render mask neutralizes unrequired lanes meanwhile.

``plan`` is a pure function of the host mirrors (numpy, and the cameras'
host poses: the worker thread reads no device tensor); ``apply`` mutates
the mirrors and writes the arena in place: a tick's loads go to the device
in one copy from a pinned host buffer, then one ``index_copy_`` per field.
``apply`` is idempotent per tick, so a retried dispatch does not load
twice.  The effective scene (``scene()``) is a new tensor each time the
mask changes; a resident chunk's lanes never move, so the pose-cell pool's
sorted lists keep addressing the same Gaussians.

Residency is checkpoint state: ``state_dict``/``load_state`` carry the
arena and the JSON-able mirrors, with the partition geometry checked on
load, so a restore at a partially resident state resumes bit-identically.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import posecell
from ..data.scenes import (BYTES_PER_GAUSSIAN, LEVEL_FULL, LEVEL_LOD,
                           ChunkedScene, SceneArrays, chunk_levels,
                           level_rows, masked_scene, neutral_scene)
from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

# float32 columns per Gaussian in a load buffer: the six fields flattened
_FIELD_COLS = (3, 3, 4, 1, 3, 9)


class StreamPlan(NamedTuple):
    """One tick's residency decisions (the pure output of ``plan``)."""

    tick: int
    evict: tuple          # chunk ids to free (grace-expired, farthest first)
    assign: tuple         # ((chunk, arena_slot), ...) for newly placed chunks
    loads: tuple          # ((chunk, rows, block_rows, is_prefetch), ...)
    stalled: frozenset    # slots whose demand could not be satisfied
    mask_rows: tuple      # [arena_slots] render rows per frame after loads
    hits: tuple           # chunk ids whose demand a prefetch had served
    required_now: tuple   # chunk ids required (> 0 rows) this tick


def _position(cam) -> np.ndarray:
    """A camera's position from its host copy of the pose."""
    return np.asarray(posecell.host_pose(cam)[0], np.float64)


class ResidencyManager:
    """Pose-cell chunk residency over a fixed device arena (see the module
    docstring).  One per stepper; the stepper's effective ``scene`` is this
    manager's masked arena.  ``device`` defaults to the card."""

    def __init__(self, chunked: ChunkedScene, *, near_radius: int = 2,
                 lod_radius: int = 4, lod_frac: float = 0.5,
                 budget_bytes: Optional[int] = None,
                 max_loads_per_tick: Optional[int] = None,
                 grace_ticks: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.chunked = chunked
        self.near_radius = int(near_radius)
        self.lod_radius = int(lod_radius)
        self.lod_frac = float(lod_frac)
        self.budget_bytes = budget_bytes
        self.max_loads_per_tick = max_loads_per_tick
        # the stepper sets the default at attach (sort window + 2)
        self.grace_ticks = grace_ticks
        cap = chunked.chunk_cap
        frame_bytes = cap * BYTES_PER_GAUSSIAN
        if budget_bytes is None:
            self.arena_slots = chunked.num_chunks
        else:
            self.arena_slots = max(1, min(chunked.num_chunks,
                                          int(budget_bytes) // frame_bytes))
        # LOD transfer block: one fixed height for every LOD load
        self.lod_block = max(1, int(np.ceil(cap * self.lod_frac)))
        # the packed chunks as one [lanes, 23] float32 matrix, the rows a
        # load gathers from, and the neutral row that pads them
        self._rows = np.concatenate(
            [x.reshape(x.shape[0], -1) for x in chunked.packed], axis=1)
        self._neutral_row = np.concatenate(
            [x.reshape(1, -1) for x in neutral_scene(1)], axis=1)[0]
        self.metrics = obs_metrics.Registry()
        self.tracer = obs_trace.NULL
        self._init_state()

    # -- state ---------------------------------------------------------------

    def _init_state(self) -> None:
        n, r = self.chunked.num_chunks, self.arena_slots
        self._loaded = np.zeros((n,), np.int64)     # rows resident per chunk
        self._prefetched = np.zeros((n,), bool)     # loaded by prefetch,
                                                    # not yet demanded
        self._last_required = np.full((n,), -(10 ** 9), np.int64)
        self._chunk_slot = {}                       # chunk -> arena slot
        self._slot_chunk = np.full((r,), -1, np.int64)
        self._mask_rows = np.zeros((r,), np.int64)
        self._applied_tick = -1
        self._counters = {'loads': 0, 'prefetch': 0, 'prefetch_hits': 0,
                          'stalls': 0, 'evictions': 0, 'loaded_bytes': 0}
        self._arena = SceneArrays(*(
            torch.from_numpy(x).to(self.device)
            for x in neutral_scene(r * self.chunked.chunk_cap)))
        self._scene = masked_scene(self._arena, self._mask_rows,
                                   self.chunked.chunk_cap)
        self.dirty = True    # the stepper must (re)take scene()

    def reset(self) -> None:
        """Cold start: empty arena, zeroed mirrors and counters."""
        self._init_state()

    def scene(self):
        """The current effective scene: the arena with every lane past its
        chunk's render budget neutralized.  Consumes the dirty flag."""
        self.dirty = False
        return self._scene

    @property
    def resident_bytes(self) -> int:
        return int(self._loaded.sum()) * BYTES_PER_GAUSSIAN

    @property
    def arena_bytes(self) -> int:
        return self.arena_slots * self.chunked.chunk_cap * BYTES_PER_GAUSSIAN

    def counters(self) -> dict:
        return dict(self._counters)

    # -- planning (pure) -----------------------------------------------------

    def _slot_requirements(self, cams: dict) -> tuple:
        """Per-slot required rows [C] and per-chunk min camera distance."""
        ch = self.chunked
        per_slot = {}
        min_dist = np.full((ch.num_chunks,), 10 ** 9, np.int64)
        for slot in sorted(cams):
            cam_cell = np.floor(_position(cams[slot])
                                / ch.cell_size).astype(np.int64)
            dist = np.abs(ch.cells - cam_cell[None, :]).max(axis=1)
            lvl = np.where(dist <= self.near_radius, LEVEL_FULL,
                           np.where(dist <= self.lod_radius, LEVEL_LOD, 0))
            per_slot[slot] = (level_rows(ch, lvl, self.lod_frac), dist)
            min_dist = np.minimum(min_dist, dist)
        return per_slot, min_dist

    def plan(self, tick: int, cams: dict, admits=frozenset()) -> StreamPlan:
        """Pure residency plan for ``tick``: reads only host mirrors and the
        cameras' host poses.  The caller sequences it after the previous
        ``apply``.  ``admits`` names slots admitted this tick, whose demand
        loads are exempt from the per-tick load budget.

        The decisions and their order are the JAX package's; the candidate
        sets and orders are built with array operations, so that a plan
        over a million-Gaussian partition (some 16k chunks, most of them
        loaded on the first tick) costs linear, not quadratic, host time."""
        ch = self.chunked
        per_slot, min_dist = self._slot_requirements(cams)
        grace = self.grace_ticks if self.grace_ticks is not None else 8

        # capacity reservation in epoch-rotated priority order (admit-tick
        # slots lead); when the union fits, every slot reserves
        for slot in sorted(per_slot):
            need = int((per_slot[slot][0] > 0).sum())
            if need > self.arena_slots:
                raise RuntimeError(
                    f'streaming arena too small: slot {slot} requires '
                    f'{need} chunk frames but the arena holds only '
                    f'{self.arena_slots}; raise the byte budget or '
                    f'shrink the near/lod radii')
        slots_sorted = sorted(per_slot)
        epoch = grace + 2
        lead = ((tick // epoch) % len(slots_sorted)) if slots_sorted else 0
        rotated = slots_sorted[lead:] + slots_sorted[:lead]
        order_slots = ([s for s in rotated if s in admits]
                       + [s for s in rotated if s not in admits])
        req = np.zeros((ch.num_chunks,), np.int64)
        reserved = []
        stalled = set()
        frames_left = self.arena_slots
        for slot in order_slots:
            rows, _ = per_slot[slot]
            new_chunks = int(((rows > 0) & (req == 0)).sum())
            if new_chunks > frames_left:
                stalled.add(slot)
                continue
            frames_left -= new_chunks
            req = np.maximum(req, rows)
            reserved.append(slot)
        loaded_after = self._loaded.copy()

        # demand: chunks some reserved slot needs beyond what is resident,
        # exempt ones (admit-tick demand) first, then nearest first
        exempt = np.zeros((ch.num_chunks,), bool)
        for slot in set(admits) & set(reserved):
            exempt |= per_slot[slot][0] > loaded_after
        demand = np.flatnonzero(req > loaded_after)
        order = demand[np.lexsort((demand, min_dist[demand],
                                   ~exempt[demand]))].tolist()

        # arena frames available: free ones, then grace-expired evictions
        # (farthest from every camera first; never a required chunk)
        free = deque(np.flatnonzero(self._slot_chunk < 0).tolist())
        resident = self._slot_chunk[self._slot_chunk >= 0]
        expired = resident[(req[resident] == 0)
                           & (tick - self._last_required[resident] >= grace)]
        evictable = deque(expired[np.lexsort(
            (expired, -min_dist[expired]))].tolist())
        budget = (self.max_loads_per_tick if self.max_loads_per_tick
                  is not None else float('inf'))
        fill = ch.fill.tolist()
        evict, assign, loads = [], [], []
        assigned = set()
        spent = 0
        for c in order:
            is_exempt = bool(exempt[c])
            if not is_exempt and spent >= budget:
                continue
            if c not in self._chunk_slot and c not in assigned:
                if free:
                    slot = free.popleft()
                elif evictable:
                    victim = evictable.popleft()
                    evict.append(victim)
                    slot = int(self._chunk_slot[victim])
                else:
                    continue
                assign.append((c, slot))
                assigned.add(c)
            rows = int(req[c])
            block = ch.chunk_cap if rows >= fill[c] else self.lod_block
            loads.append((c, rows, block, False))
            loaded_after[c] = rows
            if not is_exempt:
                spent += 1

        # prefetch hits: demanded chunks already warm from a prefetch
        hits = np.flatnonzero((req > 0) & self._prefetched
                              & (self._loaded >= req)).tolist()

        # prefetch the next ring with spare budget and free frames only
        # (prefetch never evicts: demand owns the reclaim path)
        prefetch = []
        if cams:
            pre_rows = level_rows(ch, chunk_levels(
                ch, [_position(cams[s]) for s in sorted(cams)],
                self.near_radius + 1, self.lod_radius + 1), self.lod_frac)
            cand = np.flatnonzero(pre_rows > loaded_after)
            for c in cand[np.lexsort((cand, min_dist[cand]))].tolist():
                if spent >= budget or not free:
                    break
                if not (c in self._chunk_slot or c in assigned):
                    assign.append((c, free.popleft()))
                    assigned.add(c)
                rows = int(pre_rows[c])
                block = ch.chunk_cap if rows >= fill[c] else self.lod_block
                prefetch.append((c, rows, block, True))
                loaded_after[c] = rows
                spent += 1

        # stall reserved slots whose own requirement stays unmet (denied
        # slots are stalled already)
        for slot in reserved:
            if (per_slot[slot][0] > loaded_after).any():
                stalled.add(slot)

        # render mask: required capped by loaded, per arena frame (frames
        # of evicted chunks are overwritten by ``assign`` entries)
        slot_chunk = self._slot_chunk.copy()
        for c, s in assign:
            slot_chunk[s] = c
        mask_rows = np.zeros((self.arena_slots,), np.int64)
        placed = slot_chunk >= 0
        pc = slot_chunk[placed]
        mask_rows[placed] = np.minimum(req[pc], loaded_after[pc])
        return StreamPlan(
            tick=int(tick), evict=tuple(evict), assign=tuple(assign),
            loads=tuple(loads) + tuple(prefetch),
            stalled=frozenset(stalled), mask_rows=tuple(mask_rows.tolist()),
            hits=tuple(hits),
            required_now=tuple(np.flatnonzero(req > 0).tolist()))

    # -- apply (mutates the mirrors and the device arena) --------------------

    def _write_loads(self, loads) -> None:
        """Write a tick's chunk loads into the arena: the blocks are
        gathered on the host into one buffer (pinned when the arena is on
        the card), which goes to the device in one copy, then into each
        field with one ``index_copy_``.  A lane written twice in one tick
        keeps its last write, as sequential loads would leave it."""
        cap = self.chunked.chunk_cap
        chunks = np.array([c for c, _, _, _ in loads], np.int64)
        blocks = np.array([b for _, _, b, _ in loads], np.int64)
        keeps = np.minimum(np.minimum(
            blocks, np.array([r for _, r, _, _ in loads], np.int64)),
            self.chunked.fill[chunks])
        slots = np.array([self._chunk_slot[int(c)] for c in chunks],
                         np.int64)
        load_of = np.repeat(np.arange(len(loads)), blocks)
        j = np.arange(len(load_of)) - np.repeat(np.cumsum(blocks) - blocks,
                                                blocks)
        lanes = slots[load_of] * cap + j
        # keep each lane's last write
        _, last = np.unique(lanes[::-1], return_index=True)
        pick = len(lanes) - 1 - last
        lanes, load_of, j = lanes[pick], load_of[pick], j[pick]
        real = j < keeps[load_of]
        host = torch.empty((len(lanes), self._rows.shape[1] + 1),
                           dtype=torch.float32,
                           pin_memory=self.device.type == 'cuda')
        buf = host.numpy()
        buf[:, :-1] = self._neutral_row
        buf[real, :-1] = self._rows[chunks[load_of[real]] * cap + j[real]]
        buf[:, -1] = lanes.astype(np.int32).view(np.float32)
        # a fresh pinned block per tick: the host allocator keeps it until
        # the copy that reads it has completed
        dev = host.to(self.device, non_blocking=True)
        idx = dev[:, -1].contiguous().view(torch.int32).long()
        col = 0
        for field, width in zip(self._arena, _FIELD_COLS):
            src = dev[:, col:col + width].reshape((len(lanes),)
                                                  + field.shape[1:])
            field.index_copy_(0, idx, src)
            col += width

    def apply(self, plan: StreamPlan) -> None:
        """Execute a plan: evictions, chunk loads, the render mask and the
        counters.  Idempotent per tick (hardened retries)."""
        if plan.tick == self._applied_tick:
            return
        self._applied_tick = plan.tick
        n_demand = sum(1 for ld in plan.loads if not ld[3])
        with self.tracer.span('stream.apply', tick=plan.tick,
                              loads=len(plan.loads), evict=len(plan.evict),
                              stalled=len(plan.stalled)):
            for c in plan.evict:
                self._counters['evictions'] += 1
                slot = self._chunk_slot.pop(c)
                self._slot_chunk[slot] = -1
                self._loaded[c] = 0
                self._prefetched[c] = False
            for c, slot in plan.assign:
                self._chunk_slot[c] = slot
                self._slot_chunk[slot] = c
            if plan.loads:
                self._write_loads(plan.loads)
                # [chunk, rows, is_prefetch] per load; a chunk loaded twice
                # in one tick keeps its last load, as sequential writes would
                lds = np.array([(c, r, p) for c, r, _b, p in plan.loads],
                               np.int64)
                _, last = np.unique(lds[::-1, 0], return_index=True)
                fin = lds[len(lds) - 1 - last]
                self._loaded[fin[:, 0]] = fin[:, 1]
                self._prefetched[fin[:, 0]] = fin[:, 2].astype(bool)
                n_pref = int(lds[:, 2].sum())
                self._counters['loads'] += len(lds) - n_pref
                self._counters['prefetch'] += n_pref
                self._counters['loaded_bytes'] += \
                    int(lds[:, 1].sum()) * BYTES_PER_GAUSSIAN
            self._prefetched[list(plan.hits)] = False
            self._counters['prefetch_hits'] += len(plan.hits)
            self._counters['stalls'] += len(plan.stalled)
            self._last_required[list(plan.required_now)] = plan.tick
            new_mask = np.asarray(plan.mask_rows, np.int64)
            if plan.loads or plan.evict \
                    or (new_mask != self._mask_rows).any():
                self._mask_rows = new_mask
                self._scene = masked_scene(self._arena, new_mask,
                                           self.chunked.chunk_cap)
                self.dirty = True
        self.metrics.counter('stream.loads', 'demand chunk loads').inc(
            n_demand)
        self.metrics.counter('stream.prefetch',
                             'speculative chunk loads').inc(
                                 len(plan.loads) - n_demand)
        self.metrics.counter(
            'stream.prefetch_hits',
            'demands served warm by a prior prefetch').inc(len(plan.hits))
        self.metrics.counter(
            'stream.stalls',
            'slot-ticks stalled on a missing chunk').inc(len(plan.stalled))
        self.metrics.counter('stream.evictions',
                             'arena frames reclaimed').inc(len(plan.evict))
        self.metrics.gauge(
            'stream.resident_bytes',
            'Gaussian bytes resident in the arena').set(
                float(self.resident_bytes))
        self.metrics.gauge(
            'stream.arena_bytes',
            'device bytes allocated to the streaming arena').set(
                float(self.arena_bytes))

    # -- checkpoint/restore --------------------------------------------------

    def state_dict(self, copy: bool = True) -> tuple:
        """``(arrays, meta)``: the device arena and the JSON-able residency
        mirrors and partition geometry.  The arena tensors are clones
        unless ``copy=False`` (a caller that copies them before the next
        tick writes the arena in place)."""
        take = torch.clone if copy else (lambda x: x)
        arrays = {'arena': SceneArrays(*(take(x) for x in self._arena))}
        meta = {
            'geometry': self.chunked.meta_dict(),
            'near_radius': self.near_radius,
            'lod_radius': self.lod_radius,
            'lod_frac': self.lod_frac,
            'budget_bytes': self.budget_bytes,
            'max_loads_per_tick': self.max_loads_per_tick,
            'grace_ticks': self.grace_ticks,
            'arena_slots': self.arena_slots,
            'applied_tick': int(self._applied_tick),
            'resident': [[int(c), int(s), int(self._loaded[c]),
                          int(self._last_required[c]),
                          bool(self._prefetched[c])]
                         for c, s in sorted(self._chunk_slot.items())],
            'mask_rows': [int(r) for r in self._mask_rows],
            'counters': dict(self._counters),
        }
        return arrays, meta

    def load_state(self, arrays, meta: dict) -> None:
        """Restore a ``state_dict`` snapshot (or ``interop``'s form of the
        JAX package's).  The arena is copied onto this manager's device, so
        later loads never write into the caller's arrays."""
        geo = meta['geometry']
        if (geo['num_chunks'] != self.chunked.num_chunks
                or geo['chunk_cap'] != self.chunked.chunk_cap
                or geo['source_count'] != self.chunked.source_count):
            raise ValueError(
                f'streaming checkpoint geometry mismatch: snapshot '
                f'{geo["num_chunks"]}x{geo["chunk_cap"]} '
                f'(source {geo["source_count"]}) vs live partition '
                f'{self.chunked.num_chunks}x{self.chunked.chunk_cap} '
                f'(source {self.chunked.source_count})')
        self._init_state()
        self._arena = SceneArrays(*(
            torch.as_tensor(x).to(self.device, copy=True)
            for x in arrays['arena']))
        self._applied_tick = int(meta['applied_tick'])
        for c, s, rows, last_req, prefetched in meta['resident']:
            self._chunk_slot[int(c)] = int(s)
            self._slot_chunk[int(s)] = int(c)
            self._loaded[int(c)] = int(rows)
            self._last_required[int(c)] = int(last_req)
            self._prefetched[int(c)] = bool(prefetched)
        self._mask_rows = np.asarray(meta['mask_rows'], np.int64)
        self._counters = dict(meta['counters'])
        self._scene = masked_scene(self._arena, self._mask_rows,
                                   self.chunked.chunk_cap)
        self.dirty = True

    def state_template(self) -> dict:
        """An arena-shaped arrays tree for the checkpoint loader (only its
        shapes and structure are read)."""
        return {'arena': self._arena}
