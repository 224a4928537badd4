"""The port's ``ThreadedDriver`` against its ``SyncDriver`` and the JAX
package's drivers, on the CPU.

* The threaded driver replays the sync driver bit for bit (images
  ``torch.equal``, cache tags/age/clock, sort log, admission and finish
  ticks, sorted flags, hit rates), and both equal the JAX package's sync
  run (integers exact, images within 128 ulps x magnitude): the oracle of
  ``tests/test_serve_async.py:182``.
* A concurrent observer never sees an admission half applied
  (``tests/test_serve_async.py:196``); ``plan_tick`` is pure and a stale
  plan is refused (``:319``), as in the JAX package.
* The threaded double population: 4 pace-2 viewers oversubscribe 2 slots
  (``tests/test_dropless.py:163``), against the JAX package's sync run with
  its stale-unstash-index fault fixed in the test (``fix_jax_unstash``).
* Draining under the host fault kinds with worker deaths
  (``tests/test_chaos.py:236``): the port's threaded run makes the JAX
  package's threaded run's decisions, every frame lands, the fault
  counters equal the fired events and no planner thread leaks.
* Every camera that reaches planning (``plan_step`` and the residency
  plan, on the worker thread) carries its host pose, also after a
  checkpoint restore: the worker never reads a device tensor.

The JAX package's oracle also asserts that some host planning overlapped
a device window (``overlap_ms > 0``).  On the CPU the port's device work
is done by the time ``step_dispatch`` returns, so that window is near
empty and such an assertion would be flaky; these tests hold the
decisions, ``host_ms >= 0`` and the trace structure
(``test_torch_export.py``), and ``chip_smoke.py`` prints the overlap on
the card.

64x64, ``structured_scene(PRNGKey(7), 800)``.
"""
import dataclasses
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.serve import faults as jfaults
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as tpipe
from repro_torch.data import scenes as tscenes
from repro_torch.serve import faults as tfaults
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from repro_torch.serve import streaming as tstreaming
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                fix_jax_unstash, port_sessions, sessions,
                                trajs)
from torch_stepper_parity import (_np, assert_images_ulp_close, make_scene,
                                  to_cam)

FRAMES = 3
ARRIVALS = (0, 0, 1, 6, 9)
# every host fault kind a single-device driver reaches
HOST_KINDS = tuple(k for k in jfaults.KINDS if k != 'device_loss')


@pytest.fixture(scope='module')
def scene():
    return make_scene()


@pytest.fixture(scope='module')
def steppers(scene):
    """One JAX and one port private-mode stepper (2 slots), reset per run."""
    jscene, tscene = scene
    cam0 = trajs(1, 1)[0][0]
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=192, window=3), cam0, 2)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=192, window=3), to_cam(cam0), 2,
        device='cpu')
    return jst, tst


def _run(pkg, stepper, driver, *, arrivals=ARRIVALS, frames=FRAMES,
         slots=2, mgr_kw=None, sess_kw=None, observe=None):
    """One fresh run of ``pkg`` (``JAX`` or ``PORT``): every tick's
    ``{slot: image}`` (numpy) and what the parity compares.
    ``observe(mgr, stop)`` runs beside the loop on its own thread until the
    run ends."""
    session, make = pkg
    stepper.reset()
    images = []
    finish = stepper.step_finish

    def recording(infl):
        out = finish(infl)
        if out:
            images.append({s: _np(img) for s, (img, _st, _t) in out.items()})
        return out

    stepper.step_finish = recording
    mgr = session.SessionManager(stepper, slots, **(mgr_kw or {}))
    tr = trajs(len(arrivals), frames, spread=72.0, start=0.0)
    for s in make(session.ViewerSession, tr, arrival_tick=arrivals,
                  **(sess_kw or {})):
        mgr.submit(s)
    stop = threading.Event()
    th = None
    if observe is not None:
        th = threading.Thread(target=observe, args=(mgr, stop), daemon=True)
        th.start()
    try:
        finished = sorted(mgr.run(driver=driver), key=lambda s: s.sid)
    finally:
        del stepper.step_finish
        stop.set()
        if th is not None:
            th.join(timeout=5.0)
            assert not th.is_alive()
    c = stepper.shared.cache
    return {
        'mgr': mgr, 'images': images, 'ticks': mgr.tick,
        'cache': tuple(_np(getattr(c, f)) for f in ('tags', 'age', 'clock')),
        'values': _np(c.values),
        'sort_log': list(stepper.sort_log),
        'admitted': [s.telemetry.admitted_tick for s in finished],
        'finished_at': [s.telemetry.finished_tick for s in finished],
        'frames': [s.telemetry.frames for s in finished],
        'sorted_flags': [s.telemetry.sorted_flags for s in finished],
        'hit_rates': [s.telemetry.hit_rates for s in finished],
    }


def _assert_runs_equal(got, want, what, exact):
    assert len(got['images']) == len(want['images']), what
    for t, (g, w) in enumerate(zip(got['images'], want['images'])):
        assert sorted(g) == sorted(w), f'{what}: tick {t} slots'
        for slot in w:
            if exact:
                np.testing.assert_array_equal(
                    g[slot], w[slot], err_msg=f'{what}: tick {t} slot {slot}')
            else:
                assert_images_ulp_close(g[slot], w[slot],
                                        err_msg=f'{what}: tick {t} {slot}')
    for name, x, y in zip(('tags', 'age', 'clock'), got['cache'],
                          want['cache']):
        np.testing.assert_array_equal(x, y, err_msg=f'{what}: cache {name}')
    for key in ('ticks', 'sort_log', 'admitted', 'finished_at', 'frames',
                'sorted_flags', 'hit_rates'):
        assert got[key] == want[key], f'{what}: {key}'


JAX = (jsession, sessions)
PORT = (tsession, port_sessions)


def test_threaded_replays_sync_and_equals_jax(steppers):
    jst, tst = steppers
    want = _run(JAX, jst, 'sync')
    sync = _run(PORT, tst, 'sync')
    threaded = _run(PORT, tst, 'threaded')
    _assert_runs_equal(threaded, sync, 'threaded vs sync', exact=True)
    _assert_runs_equal(sync, want, 'port vs JAX', exact=False)
    assert want['ticks'] > FRAMES and any(a > 0 for a in want['admitted'])
    log = threaded['mgr'].tick_log
    assert log and all(t['host_ms'] >= 0.0 and t['overlap_ms'] >= 0.0
                       for t in log)
    assert 'serve.thread_leaks' not in threaded['mgr'].metrics


def test_threaded_admission_never_observed_partial(steppers):
    jst, tst = steppers
    arrivals = (0, 0, 0, 1, 2, 3)
    violations = []

    def observer(mgr, stop):
        sids = sorted(range(len(arrivals)))
        while not stop.is_set():
            snap = mgr.snapshot()
            seen = (list(snap['pending'])
                    + [sid for _slot, sid, _at in snap['slotted']]
                    + list(snap['finished']))
            if sorted(seen) != sids:
                violations.append(('conservation', snap))
            for _slot, _sid, admitted in snap['slotted']:
                if admitted < 0 or admitted > snap['tick']:
                    violations.append(('unstamped admission', snap))
            time.sleep(0)

    got = _run(PORT, tst, 'threaded', arrivals=arrivals,
               frames=2, observe=observer)
    want = _run(JAX, jst, 'threaded', arrivals=arrivals,
                frames=2)
    assert not violations, violations[:3]
    assert got['frames'] == [2] * len(arrivals)
    for key in ('ticks', 'admitted', 'finished_at', 'sort_log'):
        assert got[key] == want[key], key


def test_plan_tick_is_pure_and_stale_plan_rejected(steppers):
    jst, tst = steppers
    plans = []
    for (session, make), st in ((JAX, jst), (PORT, tst)):
        st.reset()
        mgr = session.SessionManager(st, 2)
        tr = trajs(len(ARRIVALS), FRAMES, spread=72.0, start=0.0)
        for s in make(session.ViewerSession, tr, arrival_tick=ARRIVALS):
            mgr.submit(s)
        p1, p2 = mgr.plan_tick(), mgr.plan_tick()
        assert (p1.tick, p1.evict, p1.admit) == (p2.tick, p2.evict, p2.admit)
        assert len(mgr.pending) == len(ARRIVALS) and not mgr.active_slots()
        assert p1.sort_plan.admits == tuple(sorted(p1.cams))
        with pytest.raises(RuntimeError, match='stale plan'):
            mgr.apply_plan(dataclasses.replace(p1, tick=p1.tick + 3))
        plans.append((p1.tick, p1.evict, p1.admit, sorted(p1.cams),
                      p1.sort_plan.admits, p1.sort_plan.due))
    assert plans[1] == plans[0]


def test_threaded_double_population(scene, monkeypatch):
    """4 pace-2 viewers on 2 physical slots of one scene, threaded: every
    session finishes its trajectory, the slots are shared, and every tick
    equals the sync run and the JAX package's."""
    fix_jax_unstash(monkeypatch)
    jscene, tscene = scene
    frames = 5
    tr = trajs(1, 1)[0][0]
    runs = {}
    for name, pkg, st in (
            ('jax', JAX, jstepper.BatchedStepper(
                jscene, jpipe.LuminaConfig(capacity=192, window=3), tr, 2,
                viewers_per_scene=2)),
            ('port', PORT, tstepper.BatchedStepper(
                tscene, tpipe.LuminaConfig(capacity=192, window=3),
                to_cam(tr), 2, viewers_per_scene=2, device='cpu'))):
        drivers = ('sync',) if name == 'jax' else ('sync', 'threaded')
        for driver in drivers:
            runs[name, driver] = _run(
                pkg, st, driver, arrivals=(0, 0, 0, 0),
                frames=frames, mgr_kw={'oversubscribe': True},
                sess_kw={'pace': 2})
    got = runs['port', 'threaded']
    assert got['frames'] == [frames] * 4
    assert got['mgr'].metrics['serve.oversubscribed'].value >= 2
    assert got['ticks'] <= 2 * frames + 4
    _assert_runs_equal(got, runs['port', 'sync'], 'threaded vs sync',
                       exact=True)
    _assert_runs_equal(runs['port', 'sync'], runs['jax', 'sync'],
                       'port vs JAX', exact=False)


def _fault_counts(mgr):
    return {k[len('serve.faults{kind='):-1]: mgr.metrics[k].value
            for k in mgr.metrics.names() if k.startswith('serve.faults{')}


def test_threaded_drains_under_faults_with_worker_death(steppers):
    jst, tst = steppers
    jt = jfaults.make_trace(HOST_KINDS, 10, seed=5, rate=0.3, slots=2,
                            stall_s=0.01)
    assert 'worker_death' in jt.counts()
    runs = {}
    for name, pkg, st, inj in (
            ('jax', JAX, jst, jfaults.FaultInjector(jt)),
            ('port', PORT, tst, tfaults.FaultInjector(
                tfaults.FaultTrace.from_dict(jt.to_dict())))):
        # a worker death costs one bounded wait (0.5 s here, not 30)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            runs[name] = _run(pkg, st, 'threaded',
                              mgr_kw={'injector': inj, 'watchdog_s': 0.5})
        mgr = runs[name]['mgr']
        assert runs[name]['frames'] == [FRAMES] * len(ARRIVALS), name
        assert not inj.outstanding(), name
        assert _fault_counts(mgr) == inj.fired_counts(), name
        deaths = inj.fired_counts()['worker_death']
        assert deaths > 0
        assert mgr.metrics['serve.degraded_ticks'].value >= deaths
        assert mgr.metrics['serve.quarantined'].value == \
            inj.fired_counts().get('nan_poison', 0)
        assert 'serve.thread_leaks' not in mgr.metrics
    assert bool(torch.isfinite(tst.shared.cache.values).all())
    assert bool(jnp.isfinite(jst.shared.cache.values).all())
    _assert_runs_equal(runs['port'], runs['jax'], 'port vs JAX',
                       exact=False)
    for key in ('serve.degraded_ticks', 'serve.retries',
                'serve.quarantined'):
        assert runs['port']['mgr'].metrics[key].value == \
            runs['jax']['mgr'].metrics[key].value, key


def test_planning_reads_host_poses_only(scene, tmp_path):
    """A streamed threaded run, restored from a checkpoint of a sync run:
    every camera given to ``plan_step`` and to the residency plan has a host
    pose, and the worker thread did the planning."""
    _, tscene = scene
    cfg = tpipe.LuminaConfig(capacity=192, window=3)
    tr = trajs(2, 5, spread=40.0)
    seen = []

    def make():
        res = tstreaming.ResidencyManager(
            tscenes.partition_scene(tscene, cell_size=0.4, chunk_cap=64),
            near_radius=3, lod_radius=5, max_loads_per_tick=4, device='cpu')
        st = tstepper.BatchedStepper(tscene, cfg, to_cam(tr[0][0]), 2,
                                     streaming=res, device='cpu')
        plan_step, plan = st.plan_step, res.plan

        def checked(fn):
            def wrapper(*args, **kw):
                cams = args[0] if fn is plan_step else args[1]
                seen.append((threading.current_thread().name,
                             all(c.host_pose is not None
                                 for c in cams.values())))
                return fn(*args, **kw)
            return wrapper

        st.plan_step, res.plan = checked(plan_step), checked(plan)
        return st

    st = make()
    mgr = tsession.SessionManager(st, 2)
    mgr.enable_checkpoints(CheckpointManager(tmp_path), every=2)
    for s in port_sessions(tsession.ViewerSession, tr, arrival_tick=(0, 1)):
        mgr.submit(s)
    while mgr.tick < 3:
        mgr.run_tick()
        mgr.evict_finished()
        mgr.maybe_checkpoint()
    mgr._ckpt.wait()
    st2 = make()
    mgr2 = tsession.SessionManager(st2, 2)
    restored = mgr2.restore_serving(
        CheckpointManager(tmp_path),
        port_sessions(tsession.ViewerSession, tr, arrival_tick=(0, 1)))
    assert restored == 2
    assert all(c.host_pose is not None for c in st2._slot_cams)
    seen.clear()
    finished = mgr2.run(driver='threaded')
    assert sorted(s.sid for s in finished) == [0, 1]
    assert all(s.cursor == 5 for s in finished)
    assert seen and all(ok for _, ok in seen)
    assert any(name == 'serve-host-planner' for name, _ in seen)
