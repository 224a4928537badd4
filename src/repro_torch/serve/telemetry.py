"""Per-session render telemetry for the multi-viewer server.

Each viewer session accumulates per-frame observations (wall-clock latency of
the batched tick it rode in, split into the tick's **sort-phase** and
**shade-phase** wall time, radiance-cache hit rate, whether its slot ran a
speculative sort) and summarises them into the numbers an operator watches:
frames/sec, mean hit rate, p50/p99 frame latency, the realised sort cadence
(sorts per frame; 1/window when S^2 is keeping up — this counts sort
*refreshes the viewer consumed*, scheduled or adopted from a pose-cell
leader, so it stays ~1/window even when scene-sharing means far fewer
sorts *executed*; the executed count lives in the tick rollup) and mean
per-phase cost.
The per-tick sorted-slot counts live on ``SessionManager.tick_log`` — see
``tick_rollup`` for the fleet-level view the cohort scheduler is judged by
(max sorted slots per tick <= ceil(S/window) after warmup).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass
class SessionTelemetry:
    """Accumulated per-frame observations for one viewer session."""

    sid: int
    arrival_tick: int = 0
    admitted_tick: int = -1
    finished_tick: int = -1
    latencies_s: list = dataclasses.field(default_factory=list)
    hit_rates: list = dataclasses.field(default_factory=list)
    saved_fracs: list = dataclasses.field(default_factory=list)
    sorted_flags: list = dataclasses.field(default_factory=list)
    sort_mss: list = dataclasses.field(default_factory=list)
    shade_mss: list = dataclasses.field(default_factory=list)

    def observe_frame(self, latency_s: float, hit_rate: float,
                      saved_frac: float, sorted_flag: float,
                      sort_ms: float = 0.0,
                      shade_ms: float | None = None) -> None:
        """``sort_ms``/``shade_ms`` attribute the tick's latency to its two
        phases; ``shade_ms`` defaults to the whole tick when the engine
        cannot split (the monolithic sequential reference)."""
        self.latencies_s.append(float(latency_s))
        self.hit_rates.append(float(hit_rate))
        self.saved_fracs.append(float(saved_frac))
        self.sorted_flags.append(float(sorted_flag))
        self.sort_mss.append(float(sort_ms))
        self.shade_mss.append(float(latency_s * 1e3 if shade_ms is None
                                    else shade_ms))

    @property
    def frames(self) -> int:
        return len(self.latencies_s)

    def rollback(self, frames: int) -> None:
        """Truncate to the first ``frames`` observations — the fleet's
        device-loss recovery rolls sessions back to a checkpoint cursor and
        *replays* the tail, so without truncation every replayed frame
        would be double-counted.  Also clears ``finished_tick``: a rolled-
        back session is live again."""
        frames = max(0, int(frames))
        for name in ('latencies_s', 'hit_rates', 'saved_fracs',
                     'sorted_flags', 'sort_mss', 'shade_mss'):
            del getattr(self, name)[frames:]
        self.finished_tick = -1

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_s, np.float64)
        wall = float(lat.sum())
        queue_ticks = (self.admitted_tick - self.arrival_tick
                       if self.admitted_tick >= 0 else -1)
        return {
            'sid': self.sid,
            'frames': self.frames,
            'queue_ticks': queue_ticks,
            'fps': self.frames / wall if wall > 0 else float('inf'),
            'hit_rate': float(np.mean(self.hit_rates)) if self.hit_rates else 0.0,
            'saved_frac': (float(np.mean(self.saved_fracs))
                           if self.saved_fracs else 0.0),
            'p50_ms': float(np.percentile(lat, 50) * 1e3) if self.frames else 0.0,
            'p99_ms': float(np.percentile(lat, 99) * 1e3) if self.frames else 0.0,
            'sorts_per_frame': (float(np.mean(self.sorted_flags))
                                if self.sorted_flags else 0.0),
            'sort_ms': (float(np.mean(self.sort_mss))
                        if self.sort_mss else 0.0),
            'shade_ms': (float(np.mean(self.shade_mss))
                         if self.shade_mss else 0.0),
        }


def format_table(summaries: list[dict]) -> str:
    """Render session summaries as an aligned text table.

    Summaries may be heterogeneous — sessions admitted under different
    drivers/backends carry different keys; the table shows the union of
    columns (first-seen order) with missing cells left blank."""
    if not summaries:
        return '(no sessions)'
    cols = list(dict.fromkeys(c for s in summaries for c in s))
    missing = object()

    def fmt(v):
        if v is missing:
            return ''
        return f'{v:.3g}' if isinstance(v, float) else str(v)

    width = {c: max(len(c), max(len(fmt(s.get(c, missing)))
                                for s in summaries))
             for c in cols}
    lines = ['  '.join(c.rjust(width[c]) for c in cols)]
    for s in summaries:
        lines.append('  '.join(fmt(s.get(c, missing)).rjust(width[c])
                               for c in cols))
    return '\n'.join(lines)


def aggregate(summaries: list[dict]) -> dict:
    """Fleet-level rollup across sessions.

    ``fleet_fps`` is the frame-weighted per-viewer rate (each session's fps
    weighted by the frames it rendered — a 2-frame session no longer counts
    as much as a 200-frame one).  The legacy unweighted ``mean_fps`` field
    is gone; ``fleet_fps`` is the standard.
    """
    if not summaries:
        return {'sessions': 0, 'frames': 0}
    frames = sum(s['frames'] for s in summaries)
    fps = np.asarray([s['fps'] for s in summaries], np.float64)
    weights = np.asarray([s['frames'] for s in summaries], np.float64)
    finite = np.isfinite(fps) & (weights > 0)
    fleet_fps = (float(np.average(fps[finite], weights=weights[finite]))
                 if finite.any() else 0.0)
    return {
        'sessions': len(summaries),
        'frames': frames,
        'fleet_fps': fleet_fps,
        'mean_hit_rate': float(np.mean([s['hit_rate'] for s in summaries])),
        'worst_p99_ms': float(max(s['p99_ms'] for s in summaries)),
        'mean_sort_ms': float(np.mean([s.get('sort_ms', 0.0)
                                       for s in summaries])),
        'mean_shade_ms': float(np.mean([s.get('shade_ms', 0.0)
                                        for s in summaries])),
    }


def tick_rollup(tick_log: list[dict], warmup_ticks: int = 0) -> dict:
    """Fleet-level per-tick view of the cohort scheduler's sort activity.

    ``tick_log`` is ``SessionManager.tick_log``; ``warmup_ticks`` drops the
    leading ticks (compile + sort-on-admit bursts sit outside the scheduled
    per-tick cohort bound).

    When any tick carries a per-kernel shade breakdown (``kernel_ms``, from
    the batched stepper's sampled profiling on the pallas backend) the
    rollup's ``kernel_ms`` maps each kernel stage — prep / prefix / lookup /
    resume / insert — to its mean milliseconds over the profiled ticks, so
    the operator sees *where* shade time goes, not just its total.

    When ticks carry the stepper's state metrics (scene-shared serving) the
    rollup adds the radiance-cache warm-up view (``mean_occupancy`` /
    ``last_occupancy``) and the state-memory footprint: the peak number of
    live sort-pool entries (``max_sort_pool_live`` — the O(distinct pose
    cells) figure the scene-shared pool exists to shrink below O(S)) and
    the final cache/sort-pool byte split.

    When ticks carry the host-pipeline attribution (``latency_ms`` /
    ``host_ms`` / ``overlap_ms``, from the plan/apply/observe decomposition
    in ``repro_torch.serve.session``) the rollup adds:

    * ``p50_frame_ms`` / ``p95_frame_ms`` — per-frame latency percentiles
      (each tick's latency weighted by the frames that rode it — the number
      an open-loop client actually experiences);
    * ``host_ms`` — mean host planning (admission/eviction/pose-cell) time
      per tick;
    * ``host_overlap`` — the fraction of total host planning time that ran
      while the device window of a concurrent tick was open.  0.0 under the
      synchronous virtual-clock driver by construction; > 0 is the threaded
      driver's whole point (host work hidden behind the device step).
    """
    log = [t for t in tick_log if t['tick'] >= warmup_ticks]
    if not log:
        return {'ticks': 0, 'mean_sorts_per_tick': 0.0,
                'max_sorts_per_tick': 0, 'mean_sort_ms': 0.0,
                'mean_shade_ms': 0.0, 'kernel_ms': {}}
    sorts = [t['sorted_slots'] for t in log]
    profiled = [t['kernel_ms'] for t in log if t.get('kernel_ms')]
    kernel_ms = {}
    if profiled:
        for key in profiled[0]:
            kernel_ms[key] = float(np.mean([p[key] for p in profiled]))
    roll = {
        'ticks': len(log),
        'mean_sorts_per_tick': float(np.mean(sorts)),
        'max_sorts_per_tick': int(max(sorts)),
        'mean_sort_ms': float(np.mean([t['sort_ms'] for t in log])),
        'mean_shade_ms': float(np.mean([t['shade_ms'] for t in log])),
        'kernel_ms': kernel_ms,
    }
    # per-frame latency percentiles: each tick's latency, weighted by the
    # frames that rode it (legacy logs without latency_ms just omit these)
    lat = np.repeat([t['latency_ms'] for t in log if 'latency_ms' in t],
                    [t['frames'] for t in log if 'latency_ms' in t])
    if lat.size:
        roll['p50_frame_ms'] = float(np.percentile(lat, 50))
        roll['p95_frame_ms'] = float(np.percentile(lat, 95))
    host = [t for t in log if 'host_ms' in t]
    if host:
        total_host = float(np.sum([t['host_ms'] for t in host]))
        total_overlap = float(np.sum([t.get('overlap_ms', 0.0)
                                      for t in host]))
        roll['host_ms'] = float(np.mean([t['host_ms'] for t in host]))
        # overlap is a subset of host planning time, so the ratio cannot
        # legitimately exceed 1.0 — report it UNclamped and warn instead of
        # silently masking the accounting bug a clamp would hide (a driver
        # intersecting the wrong interval, double-counted carry, ...)
        overlap = total_overlap / total_host if total_host > 0 else 0.0
        if overlap > 1.0:
            warnings.warn(
                f'host_overlap accounting bug: overlap {total_overlap:.3f} '
                f'ms exceeds host planning time {total_host:.3f} ms '
                f'(ratio {overlap:.3f})', RuntimeWarning, stacklevel=2)
        roll['host_overlap'] = overlap
    # occupancy values may still be unsynced device scalars (the stepper
    # defers the host transfer out of the timed serving loop) — float()
    # here is where they land
    occ = [float(t['occupancy']) for t in log if 'occupancy' in t]
    if occ:
        roll['mean_occupancy'] = float(np.mean(occ))
        roll['last_occupancy'] = occ[-1]
    pool = [t['sort_pool_live'] for t in log if 'sort_pool_live' in t]
    if pool:
        roll['max_sort_pool_live'] = int(max(pool))
    # byte figures are PEAKS over the run (staggered workloads drain toward
    # the end; the final-tick snapshot would understate the footprint)
    for key in ('sort_pool_bytes', 'sort_pool_alloc_bytes',
                'sort_pool_reserved_bytes', 'cache_bytes', 'state_bytes',
                'state_alloc_bytes', 'state_reserved_bytes',
                'stream_resident_bytes', 'stream_arena_bytes',
                'stream_full_bytes'):
        vals = [t[key] for t in log if key in t]
        if vals:
            roll[key] = int(max(vals))
    # streaming counters are cumulative over the run — the last snapshot is
    # the total; ``stream_stalls_tail`` isolates the post-warmup window the
    # steady-state gate (CI: stalls == 0 after warmup) reads
    for key in ('stream_stalls', 'stream_loads', 'stream_prefetch_hits',
                'stream_evictions'):
        vals = [t[key] for t in log if key in t]
        if vals:
            roll[key] = int(vals[-1])
    stall_vals = [t['stream_stalls'] for t in tick_log
                  if 'stream_stalls' in t]
    if stall_vals:
        warm = (stall_vals[min(warmup_ticks, len(stall_vals)) - 1]
                if warmup_ticks else 0)
        roll['stream_stalls_tail'] = int(stall_vals[-1] - warm)
    return roll
