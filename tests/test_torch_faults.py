"""The port's fault layer against the JAX package's, on the CPU.

* ``faults.make_trace`` equals the JAX package's draw for draw (several
  seeds, kinds and rates) and traces round-trip between the packages; the
  injector fires one-shot, deferred, as JAX's.
* The ``isfinite`` insert gate, and a NaN camera driven through the real
  shade on both backends: the cache stays finite and equal to JAX's.
* The sync driver drains ``tests/test_chaos.py``'s seeded fault trace with
  the same decisions as JAX on every tick and counters that equal the
  fired events; an enabled injector with an empty trace is bit-identical to
  the NULL one; ``max_pending`` sheds; a poisoned slot is quarantined and
  its neighbour untouched.

64x64, ``structured_scene(PRNGKey(7), 800)``, 2 private slots.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import radiance_cache as jrc
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import faults as jfaults
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch.core import pipeline as tpipe
from repro_torch.core import radiance_cache as trc
from repro_torch.serve import faults as tfaults
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                drive_pair, port_sessions, sessions,
                                sync_tick, trajs)
from torch_stepper_parity import (_np, assert_images_ulp_close, make_scene,
                                  to_cam)

FRAMES = 3
ARRIVALS = (0, 0, 1, 6, 9)
SYNC_KINDS = ('plan_exc', 'dispatch_transient', 'dispatch_persistent',
              'stall', 'nan_poison')


@pytest.fixture(scope='module')
def steppers():
    """One JAX and one port private-mode stepper (2 slots), reset per run:
    compiling the JAX stepper dominates this file."""
    jscene, tscene = make_scene()
    cam0 = trajs(1, 1)[0][0]
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=192, window=3), cam0, 2)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=192, window=3), to_cam(cam0), 2,
        device='cpu')
    return jst, tst


def _managers(steppers, jinj, tinj, frames=FRAMES, arrivals=ARRIVALS,
              **kw):
    jst, tst = steppers
    jst.reset()
    tst.reset()
    tr = trajs(len(arrivals), frames, spread=72.0, start=0.0)
    jmgr = jsession.SessionManager(jst, 2, injector=jinj, **kw)
    tmgr = tsession.SessionManager(tst, 2, injector=tinj, **kw)
    for s in sessions(jsession.ViewerSession, tr, arrival_tick=arrivals):
        jmgr.submit(s)
    for s in port_sessions(tsession.ViewerSession, tr,
                           arrival_tick=arrivals):
        tmgr.submit(s)
    return jmgr, tmgr


def _counters(mgr, prefix):
    return {k: mgr.metrics[k].value for k in mgr.metrics.names()
            if k.startswith(prefix)}


# -- traces and the injector ----------------------------------------------

@pytest.mark.parametrize('kinds,ticks,seed,rate,slots', [
    (jfaults.KINDS, 40, 3, 0.2, 4),
    (SYNC_KINDS, 10, 11, 0.3, 2),
    (('nan_poison',), 25, 0, 0.05, 1),
    (('stall', 'plan_exc'), 60, 12345, 1.0, 8),
])
def test_make_trace_equals_jax(kinds, ticks, seed, rate, slots):
    kw = dict(seed=seed, rate=rate, slots=slots, stall_s=0.01,
              transient_count=2)
    tt = tfaults.make_trace(kinds, ticks, **kw)
    jt = jfaults.make_trace(kinds, ticks, **kw)
    assert tt.to_dict() == jt.to_dict()
    assert tt.counts() == jt.counts()
    assert tfaults.FaultTrace.from_dict(jt.to_dict()) == tt
    assert jfaults.FaultTrace.from_dict(tt.to_dict()) == jt


def test_trace_validation_and_one_shot_injector():
    assert tfaults.KINDS == jfaults.KINDS
    with pytest.raises(ValueError):
        tfaults.make_trace(('no_such_kind',), 10)
    with pytest.raises(ValueError):
        tfaults.make_trace(('stall',), 10, rate=1.5)
    with pytest.raises(ValueError):
        tfaults.FaultEvent(tick=0, kind='no_such_kind')
    events = (tfaults.FaultEvent(tick=2, kind='stall'),
              tfaults.FaultEvent(tick=5, kind='stall'),
              tfaults.FaultEvent(tick=3, kind='nan_poison', slot=1))
    inj = tfaults.FaultInjector(tfaults.FaultTrace(seed=0, events=events))
    assert inj.take('stall', 0) is None
    assert inj.peek('stall', 2)
    assert inj.take('stall', 4).tick == 2        # deferred past tick 2
    assert inj.take('stall', 4) is None          # one-shot; next arms at 5
    assert inj.take('stall', 7).tick == 5
    assert inj.fired_counts() == {'stall': 2}
    assert inj.outstanding() == {'nan_poison': 1}
    ev = inj.take('nan_poison', 3)
    assert tfaults.FaultInjector.poison_slot(ev, [0, 1]) == 1
    assert tfaults.FaultInjector.poison_slot(ev, [0, 2]) == 0
    left = tfaults.FaultInjector(tfaults.FaultTrace(seed=0, events=events))
    with pytest.warns(RuntimeWarning, match='unfired'):
        assert tfaults.account_unfired(left) == {'stall': 2, 'nan_poison': 1}
    assert not tfaults.NULL.enabled and tfaults.NULL.take('stall', 9) is None


# -- the insert gate and a NaN camera ---------------------------------------

def test_insert_gate_blocks_nonfinite_rgb():
    jcfg = jrc.CacheConfig(n_sets=16, n_ways=2)
    tcfg = trc.CacheConfig(n_sets=16, n_ways=2)
    ids = np.arange(4 * jcfg.k, dtype=np.int32).reshape(1, 4, jcfg.k)
    rgb = np.ones((1, 4, 3), np.float32)
    rgb[0, 1, 0], rgb[0, 3, 2] = np.nan, np.inf
    do = np.ones((1, 4), bool)
    want = jrc.insert_all_groups(jrc.init_cache(1, jcfg), jnp.asarray(ids),
                                 jnp.asarray(rgb), jnp.asarray(do), jcfg)
    got = trc.insert_all_groups(trc.init_cache(1, tcfg),
                                torch.from_numpy(ids), torch.from_numpy(rgb),
                                torch.from_numpy(do), tcfg)
    assert bool(torch.isfinite(got.values).all())
    assert int((got.tags[..., 0] != trc.INVALID_TAG).sum()) == 2
    for f in ('tags', 'values', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize('backends', [('reference', 'reference'),
                                      ('pallas', 'kernel')])
def test_nan_camera_cannot_poison_shared_cache(backends):
    """A NaN camera through the real shade after one finite frame, at
    64x48 so that some pixels miss: each port backend leaves its JAX
    counterpart's cache, finite (values within 128 ulps, the kernel
    backend's black NaN-frame inserts included).  The two backends differ
    here in both packages: the reference's raw colors are NaN, so the
    insert gate keeps the misses out, while the kernel path shades them
    black and inserts them (``chip_smoke.nan_camera_check`` holds that on
    the card)."""
    jscene, tscene = make_scene()
    cams = jax_orbit(2, width=64, height_px=48)
    bad = tfaults.poison_camera(to_cam(cams[1]))
    assert all(bool(torch.isnan(getattr(bad, f)).all())
               for f in ('position', 'quat', 'fx', 'fy', 'cx', 'cy'))
    assert np.isnan(bad.host_pose[0]).all()
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=192, window=3,
                                   backend=backends[0]), cams[0], 1)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=192, window=3,
                                   backend=backends[1]), to_cam(cams[0]), 1,
        device='cpu')
    outs = []
    for st, first, second in ((jst, cams[0], jfaults.poison_camera(cams[1])),
                              (tst, to_cam(cams[0]), bad)):
        st.admit(0)
        st.step({0: first})
        outs.append(st.step({0: second})[0])
    pixels = 64 * 48
    hits = [round(float(o[1].hit_rate) * pixels) for o in outs]
    assert hits[1] == hits[0] < pixels
    assert bool(torch.isfinite(outs[1][0]).all()) == \
        bool(np.isfinite(np.asarray(outs[0][0])).all())
    assert bool(torch.isfinite(tst.shared.cache.values).all())
    for f in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(tst.shared.cache, f)),
                                      np.asarray(getattr(jst.shared.cache, f)),
                                      f)
    assert_images_ulp_close(_np(tst.shared.cache.values),
                            np.asarray(jst.shared.cache.values),
                            err_msg='values')


# -- serving under injected faults ------------------------------------------

def test_sync_driver_drains_under_faults_as_jax(steppers):
    jt = jfaults.make_trace(SYNC_KINDS, 10, seed=11, rate=0.3, slots=2,
                            stall_s=0.01)
    tt = tfaults.FaultTrace.from_dict(jt.to_dict())
    assert len(tt.counts()) >= 4, 'the seed must schedule a broad mix'
    jinj, tinj = jfaults.FaultInjector(jt), tfaults.FaultInjector(tt)
    jmgr, tmgr = _managers(steppers, jinj, tinj)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        drive_pair(jmgr, tmgr)
    assert sorted(s.sid for s in tmgr.finished) == [0, 1, 2, 3, 4]
    assert all(s.telemetry.frames == FRAMES for s in tmgr.finished)
    assert not tinj.outstanding()
    assert tinj.fired_counts() == jinj.fired_counts()
    assert _counters(tmgr, 'serve.faults{') == \
        {f'serve.faults{{kind={k}}}': n
         for k, n in tinj.fired_counts().items()}
    for prefix in ('serve.faults{', 'serve.retries', 'serve.degraded_ticks',
                   'serve.quarantined'):
        assert _counters(tmgr, prefix) == _counters(jmgr, prefix), prefix
    assert _counters(tmgr, 'serve.quarantined')['serve.quarantined'] == \
        tinj.fired_counts()['nan_poison']
    assert bool(torch.isfinite(tmgr.stepper.shared.cache.values).all())


def test_enabled_empty_injector_is_bit_identical(steppers):
    """The hardened helpers reduce to the plain path: an enabled injector
    whose trace is empty (every check a live call, containment scanning
    every tick) renders what the NULL injector renders, bit for bit."""
    _, tst = steppers
    runs = []
    for inj in (tfaults.NULL,
                tfaults.FaultInjector(tfaults.FaultTrace(seed=0,
                                                         events=()))):
        tst.reset()
        mgr = tsession.SessionManager(tst, 2, injector=inj)
        for s in port_sessions(tsession.ViewerSession,
                               trajs(len(ARRIVALS), FRAMES, spread=72.0,
                                     start=0.0),
                               arrival_tick=ARRIVALS):
            mgr.submit(s)
        frames = []
        while not mgr.drained():
            _, out = sync_tick(mgr)
            frames.append({s: o[0] for s, o in out.items()})
        runs.append((frames, list(tst.sort_log),
                     [s.telemetry.frames for s in mgr.finished]))
    (f0, log0, n0), (f1, log1, n1) = runs
    assert log0 == log1 and n0 == n1 and len(f0) == len(f1)
    for a, b in zip(f0, f1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[s], b[s]) for s in a)


def test_load_shedding_bounds_the_backlog(steppers):
    _, tst = steppers
    tst.reset()
    mgr = tsession.SessionManager(tst, 2, max_pending=3)
    ss = port_sessions(tsession.ViewerSession,
                       trajs(5, 2, spread=72.0, start=0.0))
    assert [mgr.submit(s) for s in ss] == [True, True, True, False, False]
    assert [s.sid for s in mgr.shed] == [3, 4]
    assert mgr.metrics['serve.shed'].value == 2
    assert sorted(s.sid for s in mgr.run()) == [0, 1, 2]


def test_quarantine_resets_slot_and_keeps_neighbors(steppers):
    ev = dict(tick=2, kind='nan_poison', slot=1)
    jinj = jfaults.FaultInjector(jfaults.FaultTrace(
        seed=0, events=(jfaults.FaultEvent(**ev),)))
    tinj = tfaults.FaultInjector(tfaults.FaultTrace(
        seed=0, events=(tfaults.FaultEvent(**ev),)))
    jmgr, tmgr = _managers(steppers, jinj, tinj, arrivals=(0, 0))
    drive_pair(jmgr, tmgr)
    assert tinj.fired_counts() == {'nan_poison': 1}
    assert tmgr.metrics['serve.quarantined'].value == 1
    by_sid = {s.sid: s for s in tmgr.finished}
    assert by_sid[0].telemetry.frames == by_sid[1].telemetry.frames == FRAMES
    assert by_sid[1].telemetry.finished_tick \
        > by_sid[0].telemetry.finished_tick
