"""Multi-viewer render-serving entry point.

Serves N concurrent camera streams (staggered arrivals, per-viewer orbit
trajectories) over one Gaussian scene with a fixed number of render slots,
then prints per-session telemetry:

    PYTHONPATH=src python -m repro_torch.serve.render --viewers 4 --frames 24
    PYTHONPATH=src python -m repro_torch.serve.render --device cpu \\
        --viewers 2 --frames 3 --width 64 --gaussians 600
    PYTHONPATH=src python -m repro_torch.serve.render --device cpu \\
        --viewers 4 --viewers-per-scene 2 --pace 2 --oversubscribe
    PYTHONPATH=src python -m repro_torch.serve.render --device cpu \\
        --viewers 2 --frames 3 --width 64 --gaussians 600 \\
        --driver threaded --trace-out build/trace.json
    PYTHONPATH=src python -m repro_torch.serve.render --device cpu \\
        --viewers 2 --frames 3 --width 64 --gaussians 600 --stream
    PYTHONPATH=src python -m repro_torch.serve.render --device cpu \\
        --devices 2 --viewers 4 --slots 2 --frames 3 --width 64 \\
        --gaussians 600 --faults device_loss \\
        --checkpoint-dir build/fleet_ckpt --checkpoint-every 2

Each scene's viewers orbit it from the scene's own start angle; the batched
stepper advances all slots through one slot-batched shade per tick, and
speculative sorts run only for the tick's due pose-cell groups (see
``repro_torch.serve.stepper``).  It runs on the card unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse

from .. import obs
from ..checkpoint.manager import CheckpointManager
from ..core.pipeline import LuminaConfig
from ..data.scenes import partition_scene, structured_scene
from ..data.trajectory import orbit_trajectory
from ..device import resolve_device
from . import faults as serve_faults
from . import traffic
from .session import SessionManager, ViewerSession
from .stepper import BatchedStepper, SequentialStepper
from .streaming import ResidencyManager
from .telemetry import aggregate, format_table, tick_rollup


def build_sessions(viewers: int, frames: int, *, width: int = 96,
                   stagger: int = 2, fps: float = 90.0,
                   viewers_per_scene: int = 1, arrivals=None, paces=None,
                   device=None) -> list[ViewerSession]:
    """One session per viewer, grouped into scenes of ``viewers_per_scene``.

    Scenes get distinct orbit start angles; the viewers of one scene ride
    the same trajectory (co-watching), so they land in one pose cell.
    ``arrivals``/``paces`` override the default ``sid * stagger`` arrival
    ticks and every-tick pacing (pass a ``traffic`` trace's fields).  The
    cameras lie on ``device`` (the card by default).
    """
    sessions = []
    n_scenes = -(-viewers // viewers_per_scene)
    for sid in range(viewers):
        scene_id = sid // viewers_per_scene
        cams = orbit_trajectory(frames, fps=fps, width=width, height_px=width,
                                start_deg=360.0 * scene_id / max(n_scenes, 1),
                                device=device)
        sessions.append(ViewerSession(
            sid=sid, cams=cams,
            arrival_tick=(sid * stagger if arrivals is None
                          else int(arrivals[sid])),
            scene_id=scene_id,
            pace=1 if paces is None else int(paces[sid])))
    return sessions


def serve(viewers: int, frames: int, *, slots: int = 0, width: int = 96,
          gaussians: int = 1500, window: int = 6, capacity: int = 192,
          stagger: int = 2, sequential: bool = False, seed: int = 0,
          backend: str = 'reference', profile_every: int = 0,
          viewers_per_scene: int = 1, arrivals: str = 'stagger',
          rate: float = 0.5, burst: int = 4, gap: int = 8, jitter: int = 0,
          pace: int = 1, pace_jitter: int = 0, oversubscribe: bool = False,
          driver: str = 'sync', trace_out: str | None = None,
          metrics_out: str | None = None, faults: str = '',
          fault_rate: float = 0.05, fault_seed: int = 0,
          watchdog: float | None = None, max_pending: int | None = None,
          checkpoint_dir: str | None = None, checkpoint_every: int = 0,
          restore: bool = False, stream: bool = False,
          stream_budget: int = 0, stream_near: int = 2, stream_lod: int = 4,
          stream_lod_frac: float = 0.5, stream_cell: float = 0.4,
          stream_chunk: int = 64, stream_max_loads: int = 0,
          devices: int = 1, device=None, print_fn=print) -> dict:
    """Run the serving loop to completion; returns the aggregate rollup.

    ``backend`` selects the shade ('reference' | 'kernel');
    ``profile_every`` > 0 samples a per-stage shade breakdown every N ticks
    (kernel backend, batched engine); ``viewers_per_scene`` > 1 groups that
    many slots per scene so co-scene viewers share one radiance cache and
    pose-cell sort pool (batched engine only).  ``arrivals`` selects the
    traffic trace ('stagger' | 'poisson' | 'bursty', seeded by ``seed``);
    ``driver`` the host loop: 'sync' (the virtual clock, deterministic
    replay) or 'threaded' (host planning on a worker thread, double-buffered
    against the device step).
    ``oversubscribe`` lets paced viewers whose render ticks never collide
    share one physical slot (batched engine, ``viewers_per_scene`` >= 2 and
    ``pace`` >= 2).  ``device`` defaults to the card.

    ``trace_out`` writes the run's span trace as Chrome trace-event JSON
    (open in https://ui.perfetto.dev: host / host-worker / device tracks);
    ``metrics_out`` writes the metrics registry's JSON snapshot.

    ``faults`` turns on deterministic fault injection (``serve.faults``): a
    comma list of fault kinds or ``'all'``, scheduled per tick at
    ``fault_rate`` from ``fault_seed``.  ``watchdog`` bounds each tick's
    finish (seconds) and ``max_pending`` the admission backlog (arrivals
    past it are shed).  ``checkpoint_dir`` + ``checkpoint_every`` snapshot
    the serving state every N ticks (atomic, crash-consistent:
    ``repro_torch.checkpoint``); ``restore`` resumes from the newest
    complete snapshot instead of starting cold.

    ``stream`` turns on pose-cell scene residency
    (``repro_torch.serve.streaming``): the scene is partitioned into
    cell-keyed chunks (``stream_cell`` cell size, ``stream_chunk``
    Gaussians a chunk) and only the live cells' chunks stay on the device:
    full detail within ``stream_near`` cells of a camera, a significance
    prefix (``stream_lod_frac`` of each chunk) out to ``stream_lod`` cells.
    ``stream_budget`` bounds the device arena in bytes (0: one frame per
    chunk) and ``stream_max_loads`` the chunk loads a tick (0: unbounded;
    misses beyond it stall only the missing viewer's slot).

    ``devices`` > 1 serves through the elastic multi-device fleet
    (``repro_torch.serve.fleet``): ``slots`` render slots *per device
    worker*, a shared bounded admission queue with deterministic routing,
    and device-loss recovery (inject it with ``--faults device_loss``;
    checkpointing makes the recovery a whole-fleet rollback).  The workers
    cycle over the cards (``launch.mesh.serve_devices``): on one card, or
    on the CPU, they all share it.
    """
    if viewers < 1 or frames < 1:
        raise SystemExit('--viewers and --frames must be >= 1')
    if viewers_per_scene < 1:
        raise SystemExit('--viewers-per-scene must be >= 1')
    if sequential and viewers_per_scene > 1:
        raise SystemExit('--viewers-per-scene > 1 needs the batched engine '
                         '(the sequential baseline is fully private state)')
    if oversubscribe and (sequential or viewers_per_scene < 2):
        raise SystemExit('--oversubscribe needs the batched engine with '
                         '--viewers-per-scene >= 2 (co-residents interleave '
                         'through a shared scene block)')
    if oversubscribe and pace < 2:
        raise SystemExit('--oversubscribe needs --pace >= 2: only paced '
                         'viewers have the off ticks co-residents render in')
    if stream and sequential:
        raise SystemExit('--stream needs the batched engine (residency is '
                         'a property of the shared scene arena)')
    if stream and devices > 1:
        raise SystemExit('--stream is a single-device feature for now '
                         '(fleet workers hold fully-resident scene copies)')
    dev = resolve_device(device)
    slots = slots or min(viewers, 8)
    # scene blocks are static: round slots up to whole blocks
    slots = -(-slots // viewers_per_scene) * viewers_per_scene
    scene = structured_scene(seed, gaussians, device=dev)
    cfg = LuminaConfig(capacity=capacity, window=window, backend=backend)
    trace = traffic.make_trace(arrivals, viewers, seed=seed, rate=rate,
                               burst=burst, gap=gap, jitter=jitter,
                               stagger=stagger, pace=pace,
                               pace_jitter=pace_jitter)
    sessions = build_sessions(viewers, frames, width=width, stagger=stagger,
                              viewers_per_scene=viewers_per_scene,
                              arrivals=trace.arrivals, paces=trace.paces,
                              device=dev)
    cam0 = sessions[0].cams[0]

    injector = serve_faults.NULL
    fault_trace = None
    if faults:
        kinds = serve_faults.KINDS if faults == 'all' else tuple(
            k.strip() for k in faults.split(',') if k.strip())
        # arm events across the expected run: last arrival + slowest
        # viewer's frames, plus slack for degraded/shed ticks
        horizon = int(max(trace.arrivals)) + frames * int(max(trace.paces)) + 4
        fault_trace = serve_faults.make_trace(kinds, horizon, seed=fault_seed,
                                              rate=fault_rate, slots=slots)
        injector = serve_faults.FaultInjector(fault_trace)

    if devices > 1:
        if sequential:
            raise SystemExit('--devices > 1 needs the batched engine')
        if oversubscribe:
            raise SystemExit('--oversubscribe is a single-device feature '
                             '(fleet workers place one viewer per slot)')
        return _serve_fleet_path(
            scene, cfg, cam0, sessions, devices=devices, slots=slots,
            driver=driver, viewers_per_scene=viewers_per_scene,
            profile_every=profile_every, injector=injector,
            fault_trace=fault_trace, fault_rate=fault_rate,
            fault_seed=fault_seed, max_pending=max_pending,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, restore=restore,
            backend=backend, arrivals=arrivals, trace_out=trace_out,
            metrics_out=metrics_out, device=dev, print_fn=print_fn)

    if sequential:
        stepper = SequentialStepper(scene, cfg, cam0, slots, device=dev)
    else:
        streaming = None
        if stream:
            streaming = ResidencyManager(
                partition_scene(scene, cell_size=stream_cell,
                                chunk_cap=stream_chunk),
                near_radius=stream_near, lod_radius=stream_lod,
                lod_frac=stream_lod_frac,
                budget_bytes=stream_budget or None,
                max_loads_per_tick=stream_max_loads or None, device=dev)
        stepper = BatchedStepper(scene, cfg, cam0, slots,
                                 profile_every=profile_every,
                                 viewers_per_scene=viewers_per_scene,
                                 streaming=streaming, device=dev)
    tracer = obs.Tracer() if trace_out else None
    mgr = SessionManager(stepper, slots, tracer=tracer, injector=injector,
                         watchdog_s=watchdog, max_pending=max_pending,
                         oversubscribe=oversubscribe)

    ckpt = None
    restored = None
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir, metrics=mgr.metrics)
        if checkpoint_every:
            mgr.enable_checkpoints(ckpt, checkpoint_every,
                                   extra={'traffic': trace.to_dict()})
        if restore:
            restored = mgr.restore_serving(ckpt, sessions)
            if restored is not None:
                print_fn(f'-- restored serving state from tick {restored} '
                         f'({checkpoint_dir})')
    if restored is None:
        for sess in sessions:
            mgr.submit(sess)
    finished = mgr.run(driver=driver)
    if ckpt is not None:
        ckpt.wait()   # flush any in-flight background save
    if injector.enabled:
        serve_faults.account_unfired(injector, mgr.metrics)
    if trace_out:
        payload = obs.write_trace(trace_out, tracer)
        obs.validate_chrome_trace(payload)
        print_fn(f'-- trace: {len(tracer.events)} events -> {trace_out} '
                 f'(load in https://ui.perfetto.dev)')
    if metrics_out:
        with open(metrics_out, 'w') as f:
            f.write(mgr.metrics.to_json(indent=1))
        print_fn(f'-- metrics: {len(mgr.metrics.names())} instruments -> '
                 f'{metrics_out}')

    summaries = [s.telemetry.summary() for s in
                 sorted(finished, key=lambda s: s.sid)]
    agg = aggregate(summaries)
    agg['ticks'] = mgr.tick
    agg['mode'] = 'sequential' if sequential else 'batched'
    # tick-level rollup keys get a tick_ prefix: aggregate()'s
    # mean_sort_ms/mean_shade_ms are session-level means
    roll = tick_rollup(mgr.tick_log, warmup_ticks=1)
    agg['backend'] = backend
    agg['viewers_per_scene'] = viewers_per_scene
    agg['driver'] = driver
    agg['arrivals'] = arrivals
    agg['device'] = str(dev)

    def _counter(name: str) -> int:
        return mgr.metrics[name].value if name in mgr.metrics else 0

    agg['fault_rate'] = fault_rate if faults else 0.0
    agg['faults_injected'] = sum(injector.fired_counts().values())
    agg['degraded_ticks'] = _counter('serve.degraded_ticks')
    agg['retries'] = _counter('serve.retries')
    agg['quarantined'] = _counter('serve.quarantined')
    agg['shed'] = _counter('serve.shed')
    agg['oversubscribed'] = _counter('serve.oversubscribed')
    agg['pool_resizes'] = _counter('pool.resizes')
    agg['mean_sorts_per_tick'] = roll['mean_sorts_per_tick']
    agg['max_sorts_per_tick'] = roll['max_sorts_per_tick']
    agg['tick_sort_ms'] = roll['mean_sort_ms']
    agg['tick_shade_ms'] = roll['mean_shade_ms']
    agg['kernel_ms'] = roll['kernel_ms']
    for key in ('last_occupancy', 'max_sort_pool_live', 'sort_pool_bytes',
                'sort_pool_alloc_bytes', 'sort_pool_reserved_bytes',
                'cache_bytes', 'state_bytes', 'state_alloc_bytes',
                'state_reserved_bytes', 'p50_frame_ms', 'p95_frame_ms',
                'host_ms', 'host_overlap', 'stream_resident_bytes',
                'stream_arena_bytes', 'stream_full_bytes', 'stream_stalls',
                'stream_stalls_tail', 'stream_loads',
                'stream_prefetch_hits', 'stream_evictions'):
        if key in roll:
            agg[key] = roll[key]
    agg['stream_budget'] = stream_budget if stream else 0
    print_fn(format_table(summaries))
    print_fn(f"-- {agg['mode']} ({backend}, {dev}): {agg['sessions']} "
             f"sessions, {agg['frames']} frames in {agg['ticks']} ticks, "
             f"fleet {agg['fleet_fps']:.2f} fps/viewer (frame-weighted), "
             f"mean hit rate {agg['mean_hit_rate']:.2f}, "
             f"worst p99 {agg['worst_p99_ms']:.0f} ms, "
             f"sort/shade {agg['mean_sort_ms']:.1f}/"
             f"{agg['mean_shade_ms']:.1f} ms, "
             f"max {agg['max_sorts_per_tick']} sorts/tick")
    if 'max_sort_pool_live' in agg:
        occ = agg.get('last_occupancy')
        occ_s = f", cache occupancy {occ:.2f}" if occ is not None else ''
        print_fn(f"-- state ({viewers_per_scene} viewers/scene): "
                 f"{agg['max_sort_pool_live']} live sort buffers peak, "
                 f"{agg['state_bytes'] / 1e6:.1f} MB live state "
                 f"(cache {agg['cache_bytes'] / 1e6:.1f} MB + sort pool "
                 f"{agg['sort_pool_bytes'] / 1e6:.1f} MB; "
                 f"{agg['state_alloc_bytes'] / 1e6:.1f} MB allocated, "
                 f"{agg.get('state_reserved_bytes', 0) / 1e6:.1f} MB static "
                 f"reservation){occ_s}")
    if stream and 'stream_resident_bytes' in agg:
        print_fn(f"-- streaming: "
                 f"{agg['stream_resident_bytes'] / 1e6:.2f} MB resident "
                 f"peak of {agg['stream_full_bytes'] / 1e6:.2f} MB scene "
                 f"(arena {agg['stream_arena_bytes'] / 1e6:.2f} MB, budget "
                 f"{stream_budget or 'unbounded'}); "
                 f"{agg['stream_loads']} loads, "
                 f"{agg['stream_prefetch_hits']} prefetch hits, "
                 f"{agg['stream_evictions']} evictions, "
                 f"{agg['stream_stalls']} stalls "
                 f"({agg.get('stream_stalls_tail', 0)} post-warmup)")
    if roll['kernel_ms']:
        parts = '  '.join(f'{k} {v:.1f}' for k, v in roll['kernel_ms'].items())
        print_fn(f"-- shade stages (ms/tick, sampled): {parts}")
    if 'host_ms' in agg:
        print_fn(f"-- host pipeline ({driver}, {arrivals} arrivals): "
                 f"plan {agg['host_ms']:.2f} ms/tick, "
                 f"overlap {agg.get('host_overlap', 0.0):.0%}, "
                 f"frame p50/p95 {agg.get('p50_frame_ms', 0.0):.1f}/"
                 f"{agg.get('p95_frame_ms', 0.0):.1f} ms")
    if oversubscribe:
        print_fn(f"-- oversubscription: {agg['oversubscribed']} sessions "
                 f"co-placed onto occupied slots")
    if injector.enabled:
        fired = injector.fired_counts()
        fired_s = ' '.join(f'{k}={v}' for k, v in sorted(fired.items())) \
            or 'none'
        out = injector.outstanding()
        out_s = (' (unfired: '
                 + ' '.join(f'{k}={v}' for k, v in sorted(out.items()))
                 + ' — counted in serve.faults_unfired)') if out else ''
        print_fn(f"-- faults (seed {fault_seed}, rate {fault_rate}, "
                 f"{len(fault_trace.events)} scheduled): fired {fired_s}"
                 f"{out_s}; unfired {sum(out.values())}, "
                 f"retries {agg['retries']}, "
                 f"degraded ticks {agg['degraded_ticks']}, "
                 f"quarantined {agg['quarantined']}, "
                 f"shed arrivals {agg['shed']}")
    return agg


def _serve_fleet_path(scene, cfg, cam0, sessions, *, devices, slots, driver,
                      viewers_per_scene, profile_every, injector,
                      fault_trace, fault_rate, fault_seed, max_pending,
                      checkpoint_dir, checkpoint_every, restore, backend,
                      arrivals, trace_out, metrics_out, device,
                      print_fn) -> dict:
    """The ``--devices N`` serving path: the elastic multi-device fleet
    (``repro_torch.serve.fleet``) with ``slots`` render slots per device
    worker.  ``restore`` resumes from the per-device lockstep checkpoints
    under ``checkpoint_dir`` (``SystemExit`` when there are none: see
    ``serve_fleet``)."""
    from .fleet import serve_fleet
    tracer = obs.Tracer() if trace_out else None
    fleet, finished = serve_fleet(
        scene, cfg, cam0, sessions, num_devices=devices,
        slots_per_device=slots, driver=driver,
        viewers_per_scene=viewers_per_scene, profile_every=profile_every,
        ckpt_root=checkpoint_dir, ckpt_every=checkpoint_every,
        restore=restore, max_pending=max_pending,
        injector=injector, tracer=tracer, device=device)
    if fleet.restored_tick is not None:
        print_fn(f'-- restored serving state from tick '
                 f'{fleet.restored_tick} ({checkpoint_dir}, '
                 f'{devices} devices)')
    if trace_out:
        payload = obs.write_trace(trace_out, tracer)
        obs.validate_chrome_trace(payload)
        print_fn(f'-- trace: {len(tracer.events)} events -> {trace_out} '
                 f'(load in https://ui.perfetto.dev)')
    if metrics_out:
        with open(metrics_out, 'w') as f:
            f.write(fleet.metrics.to_json(indent=1))
        print_fn(f'-- metrics: {len(fleet.metrics.names())} instruments -> '
                 f'{metrics_out}')
    summaries = [s.telemetry.summary() for s in finished]
    agg = fleet.aggregate()
    agg['ticks'] = fleet.tick
    agg['mode'] = 'fleet'
    agg['backend'] = backend
    agg['viewers_per_scene'] = viewers_per_scene
    agg['driver'] = driver
    agg['arrivals'] = arrivals
    agg['device'] = str(device)
    agg['fault_rate'] = fault_rate if fault_trace is not None else 0.0
    agg['faults_injected'] = sum(injector.fired_counts().values())
    roll = tick_rollup(fleet.merged_tick_log(), warmup_ticks=1)
    for key in ('p50_frame_ms', 'p95_frame_ms', 'host_ms', 'host_overlap'):
        if key in roll:
            agg[key] = roll[key]
    print_fn(format_table(summaries))

    def _counter(name: str) -> int:
        # labelled counters register as 'name{k=v,...}': sum all series
        return sum(fleet.metrics[key].value for key in fleet.metrics.names()
                   if key == name or key.startswith(name + '{'))

    agg['devices_lost'] = _counter('fleet.device_lost')
    agg['requeued'] = _counter('fleet.requeued')
    print_fn(f"-- fleet ({backend}, {driver}): "
             f"{agg['devices']} devices ({agg['alive_devices']} alive), "
             f"{agg['sessions']} sessions, {agg['frames']} frames in "
             f"{agg['ticks']} ticks, "
             f"fleet {agg['fleet_fps']:.2f} fps/viewer (frame-weighted), "
             f"mean hit rate {agg['mean_hit_rate']:.2f}, "
             f"worst p99 {agg['worst_p99_ms']:.0f} ms, "
             f"shed arrivals {agg['shed']}")
    if injector.enabled:
        fired = injector.fired_counts()
        fired_s = ' '.join(f'{k}={v}' for k, v in sorted(fired.items())) \
            or 'none'
        out = injector.outstanding()
        out_s = (' (unfired: '
                 + ' '.join(f'{k}={v}' for k, v in sorted(out.items()))
                 + ' — counted in serve.faults_unfired)') if out else ''
        print_fn(f"-- faults (seed {fault_seed}, rate {fault_rate}, "
                 f"{len(fault_trace.events)} scheduled): fired {fired_s}"
                 f"{out_s}; unfired {sum(out.values())}, "
                 f"devices lost {agg['devices_lost']}, "
                 f"re-queued {agg['requeued']}")
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--viewers', type=int, default=4)
    ap.add_argument('--frames', type=int, default=24)
    ap.add_argument('--slots', type=int, default=0,
                    help='render slots (default min(viewers, 8))')
    ap.add_argument('--width', type=int, default=96,
                    help='square image size in pixels')
    ap.add_argument('--gaussians', type=int, default=1500)
    ap.add_argument('--window', type=int, default=6)
    ap.add_argument('--capacity', type=int, default=192)
    ap.add_argument('--stagger', type=int, default=2,
                    help='ticks between viewer arrivals')
    ap.add_argument('--sequential', action='store_true',
                    help='per-slot stepping instead of one batched shade')
    ap.add_argument('--backend', choices=('reference', 'kernel'),
                    default='reference',
                    help='shade implementation: plain PyTorch reference or '
                         'the CUDA kernel path')
    ap.add_argument('--profile-every', type=int, default=0,
                    help='sample a per-stage shade latency breakdown every '
                         'N ticks (kernel backend, batched engine)')
    ap.add_argument('--viewers-per-scene', type=int, default=1,
                    help='slots per scene block: viewers of one scene share '
                         'its radiance cache and pose-cell sort pool '
                         '(batched engine only)')
    ap.add_argument('--arrivals', choices=traffic.KINDS, default='stagger',
                    help='arrival trace: fixed stagger, open-loop poisson '
                         '(--rate viewers/tick, seeded by --seed) or bursty '
                         'flash crowds (--burst/--gap, seeded only when '
                         '--jitter > 0)')
    ap.add_argument('--rate', type=float, default=0.5,
                    help='poisson arrival rate in viewers per tick')
    ap.add_argument('--burst', type=int, default=4,
                    help='bursty arrivals: viewers landing together')
    ap.add_argument('--gap', type=int, default=8,
                    help='bursty arrivals: ticks between bursts')
    ap.add_argument('--jitter', type=int, default=0,
                    help='bursty arrivals: max seeded jitter per burst '
                         '(ticks)')
    ap.add_argument('--pace', type=int, default=1,
                    help='viewer frame interval in ticks (1 = every tick)')
    ap.add_argument('--pace-jitter', type=int, default=0,
                    help='mix client rates: pace drawn from '
                         '[pace, pace + jitter] per viewer')
    ap.add_argument('--oversubscribe', action='store_true',
                    help='interleave paced viewers whose render ticks '
                         'never collide through one physical slot (needs '
                         '--viewers-per-scene >= 2 and --pace >= 2)')
    ap.add_argument('--driver', choices=('sync', 'threaded'), default='sync',
                    help='host loop: sync (virtual clock, deterministic '
                         'replay) or threaded (host planning double-buffered '
                         'against the device step)')
    ap.add_argument('--trace-out', default=None, metavar='PATH',
                    help='write the run\'s span trace as Chrome trace-event '
                         'JSON (open in https://ui.perfetto.dev)')
    ap.add_argument('--metrics-out', default=None, metavar='PATH',
                    help='write the typed metrics registry snapshot as JSON')
    ap.add_argument('--faults', default='', metavar='KINDS',
                    help="deterministic fault injection: comma list of "
                         f"kinds from {serve_faults.KINDS} or 'all' "
                         "(seeded by --fault-seed)")
    ap.add_argument('--fault-rate', type=float, default=0.05,
                    help='per-tick per-kind Bernoulli fault probability')
    ap.add_argument('--fault-seed', type=int, default=0,
                    help='fault trace seed (independent of --seed)')
    ap.add_argument('--watchdog', type=float, default=None, metavar='SECONDS',
                    help='bound each tick\'s device finish (default: '
                         'unbounded unless faults are injected)')
    ap.add_argument('--max-pending', type=int, default=None, metavar='N',
                    help='admission backlog bound: arrivals past N pending '
                         'sessions are shed instead of queued')
    ap.add_argument('--checkpoint-dir', default=None, metavar='DIR',
                    help='snapshot serving state to this directory '
                         '(atomic, crash-consistent)')
    ap.add_argument('--checkpoint-every', type=int, default=0, metavar='N',
                    help='checkpoint cadence in ticks (0 = never)')
    ap.add_argument('--restore', action='store_true',
                    help='resume from the newest complete checkpoint in '
                         '--checkpoint-dir instead of starting cold')
    ap.add_argument('--devices', type=int, default=1, metavar='N',
                    help='serve through the elastic multi-device fleet: N '
                         'device workers with --slots slots each, a shared '
                         'bounded admission queue and device-loss recovery '
                         '(the workers cycle over the cards)')
    ap.add_argument('--stream', action='store_true',
                    help='stream the scene through a device arena of '
                         'pose-cell chunks (batched engine)')
    ap.add_argument('--stream-budget', type=int, default=0, metavar='BYTES',
                    help='device arena budget in bytes (0 = one frame per '
                         'chunk, i.e. unbounded)')
    ap.add_argument('--stream-near', type=int, default=2,
                    help='grid cells around a camera held at full detail')
    ap.add_argument('--stream-lod', type=int, default=4,
                    help='grid cells around a camera held at LOD detail')
    ap.add_argument('--stream-lod-frac', type=float, default=0.5,
                    help='fraction of each chunk (significance prefix) '
                         'loaded at LOD level')
    ap.add_argument('--stream-cell', type=float, default=0.4,
                    help='chunk grid cell size (world units)')
    ap.add_argument('--stream-chunk', type=int, default=64,
                    help='Gaussians per chunk')
    ap.add_argument('--stream-max-loads', type=int, default=0,
                    help='chunk loads per tick (0 = unbounded); misses '
                         'beyond it stall only the missing viewer')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu' for the plain "
                         'PyTorch versions')
    args = ap.parse_args(argv)
    return serve(args.viewers, args.frames, slots=args.slots,
                 width=args.width, gaussians=args.gaussians,
                 window=args.window, capacity=args.capacity,
                 stagger=args.stagger, sequential=args.sequential,
                 seed=args.seed, backend=args.backend,
                 profile_every=args.profile_every,
                 viewers_per_scene=args.viewers_per_scene,
                 arrivals=args.arrivals, rate=args.rate, burst=args.burst,
                 gap=args.gap, jitter=args.jitter, pace=args.pace,
                 pace_jitter=args.pace_jitter,
                 oversubscribe=args.oversubscribe, driver=args.driver,
                 trace_out=args.trace_out, metrics_out=args.metrics_out,
                 faults=args.faults, fault_rate=args.fault_rate,
                 fault_seed=args.fault_seed, watchdog=args.watchdog,
                 max_pending=args.max_pending,
                 checkpoint_dir=args.checkpoint_dir,
                 checkpoint_every=args.checkpoint_every,
                 restore=args.restore, stream=args.stream,
                 stream_budget=args.stream_budget,
                 stream_near=args.stream_near, stream_lod=args.stream_lod,
                 stream_lod_frac=args.stream_lod_frac,
                 stream_cell=args.stream_cell,
                 stream_chunk=args.stream_chunk,
                 stream_max_loads=args.stream_max_loads,
                 devices=args.devices, device=args.device)


if __name__ == '__main__':
    main()
