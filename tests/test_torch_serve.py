"""The port's serving stack against the JAX package's, on the CPU.

* The pure-host modules copied from the JAX package: pose-cell keys,
  ``traffic.make_trace`` and ``telemetry`` rollups, held exactly.
* The serving loop: ``build_sessions`` + ``SessionManager`` + ``SyncDriver``
  over one scene carried across through ``interop``; per-frame hit rates,
  sorted flags and the integer fields of ``telemetry.aggregate`` are equal.
* Admission shedding past ``max_pending``, a smoke test of the port's CLI,
  and the card as the entry points' default device.

The steppers' parity is in ``test_torch_stepper.py`` and
``test_torch_stepper_shared.py``.  Scenes are ``structured_scene(PRNGKey(7),
600-800)`` at 64x64.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import posecell as jposecell
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import render as jrender
from repro.serve import session as jsession
from repro.serve import stepper as jstepper
from repro.serve import telemetry as jtelemetry
from repro.serve import traffic as jtraffic

from repro_torch import interop
from repro_torch.core import pipeline as tpipe
from repro_torch.core import posecell as tposecell
from repro_torch.serve import render as trender
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from repro_torch.serve import telemetry as ttelemetry
from repro_torch.serve import traffic as ttraffic

SEED, WIDTH = 7, 64


def assert_images_ulp_close(got, want, *, ulps=128, err_msg=''):
    """Float comparison with an ulp-scaled float32 tolerance: ``ulps`` x
    float32-eps x magnitude (floored at 1.0).  Copied from
    tests/test_serve.py so this file stands alone."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0)
    tol = np.float32(ulps) * np.finfo(np.float32).eps * scale
    err = np.abs(got - want)
    worst = float((err / (np.finfo(np.float32).eps * scale)).max()) \
        if err.size else 0.0
    assert (err <= tol).all(), (
        f'{err_msg}: images differ by {worst:.0f} ulps (> {ulps} allowed)')


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                     c.cy, c.width, c.height, c.near, c.far,
                                     device='cpu')


@pytest.fixture(scope='module')
def scene():
    jscene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), 800)
    return jscene, interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                            device='cpu')


def test_pose_cell_keys_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        pos = rng.uniform(-3.0, 3.0, 3).astype(np.float32)
        quat = rng.normal(size=4).astype(np.float32)
        cam = interop.camera_from_numpy(pos, quat, 50.0, 50.0, 32.0, 32.0,
                                        64, 64, device='cpu')
        for kw in ({}, dict(cell_size=0.4, ang_bins=16)):
            assert tposecell.pose_cell_buckets(cam, **kw) == \
                jposecell.pose_cell_buckets(cam, **kw)
            assert tposecell.pose_cell_key(cam, **kw) == \
                jposecell.pose_cell_key(cam, **kw)
    # a camera made from device tensors has no host copy and reads them back
    cam = to_cam(jax_orbit(1, width=WIDTH, height_px=WIDTH)[0])
    bare = cam.replace(position=cam.position.clone(), quat=cam.quat.clone())
    assert bare.host_pose is None
    assert tposecell.pose_cell_key(bare) == tposecell.pose_cell_key(cam)


@pytest.mark.parametrize('kind,kw', [
    ('stagger', dict(stagger=3)), ('poisson', dict(rate=0.7, seed=5)),
    ('bursty', dict(burst=3, gap=5, jitter=2, seed=2)),
    ('poisson', dict(rate=0.3, seed=1, pace=2, pace_jitter=2))])
def test_traffic_traces_match_jax(kind, kw):
    want = jtraffic.make_trace(kind, 9, **kw)
    got = ttraffic.make_trace(kind, 9, **kw)
    assert got.to_dict() == want.to_dict()


def test_telemetry_rollups_match_jax():
    rng = np.random.default_rng(1)
    js, ts = [], []
    for sid in range(3):
        j = jtelemetry.SessionTelemetry(sid=sid, arrival_tick=sid)
        t = ttelemetry.SessionTelemetry(sid=sid, arrival_tick=sid)
        j.admitted_tick = t.admitted_tick = sid + 1
        for _ in range(5):
            frame = dict(latency_s=float(rng.random()),
                         hit_rate=float(rng.random()),
                         saved_frac=float(rng.random()),
                         sorted_flag=float(rng.random() < 0.3),
                         sort_ms=float(rng.random()),
                         shade_ms=float(rng.random()))
            j.observe_frame(**frame)
            t.observe_frame(**frame)
        js.append(j.summary())
        ts.append(t.summary())
    assert ts == js
    assert ttelemetry.aggregate(ts) == jtelemetry.aggregate(js)
    assert ttelemetry.format_table(ts) == jtelemetry.format_table(js)
    log = [dict(tick=i, frames=2, sorted_slots=i % 2, sort_ms=1.0 * i,
                shade_ms=2.0, latency_ms=3.0 + i, host_ms=0.1, overlap_ms=0.0,
                kernel_ms=None, occupancy=0.5, sort_pool_live=1)
           for i in range(6)]
    assert ttelemetry.tick_rollup(log, warmup_ticks=1) == \
        jtelemetry.tick_rollup(log, warmup_ticks=1)


def test_serving_loop_matches_jax():
    """``build_sessions`` + ``SessionManager`` + ``SyncDriver`` on both
    sides, one scene carried across; the port's sessions ride the JAX
    package's cameras (``orbit_trajectory`` differs by an ulp of ``fx``)."""
    jscene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), 600)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                      device='cpu')
    jsess = jrender.build_sessions(2, 4, width=WIDTH)
    tsess = trender.build_sessions(2, 4, width=WIDTH, device='cpu')
    for j, t in zip(jsess, tsess):
        assert (t.sid, t.arrival_tick, t.scene_id, t.pace) == \
            (j.sid, j.arrival_tick, j.scene_id, j.pace)
        for a, b in zip(t.cams, j.cams):
            assert_images_ulp_close(_np(a.position), b.position)
        t.cams = [to_cam(c) for c in j.cams]
    jcfg = jpipe.LuminaConfig(capacity=192, window=6)
    tcfg = tpipe.LuminaConfig(capacity=192, window=6)
    runs = []
    for sess, mk_stepper, mk_mgr in (
            (jsess, lambda c: jstepper.BatchedStepper(jscene, jcfg, c, 2),
             jsession.SessionManager),
            (tsess, lambda c: tstepper.BatchedStepper(tscene, tcfg, c, 2,
                                                      device='cpu'),
             tsession.SessionManager)):
        mgr = mk_mgr(mk_stepper(sess[0].cams[0]), slots=2)
        for s in sess:
            mgr.submit(s)
        finished = mgr.run(driver='sync')
        runs.append((mgr, sorted(finished, key=lambda s: s.sid)))
    (jmgr, jfin), (tmgr, tfin) = runs
    assert tmgr.tick == jmgr.tick
    for j, t in zip(jfin, tfin):
        assert t.telemetry.hit_rates == j.telemetry.hit_rates
        assert t.telemetry.sorted_flags == j.telemetry.sorted_flags
        assert (t.telemetry.admitted_tick, t.telemetry.finished_tick) == \
            (j.telemetry.admitted_tick, j.telemetry.finished_tick)
    jagg = jtelemetry.aggregate([s.telemetry.summary() for s in jfin])
    tagg = ttelemetry.aggregate([s.telemetry.summary() for s in tfin])
    for key in ('sessions', 'frames'):
        assert tagg[key] == jagg[key]
    assert tagg['mean_hit_rate'] == jagg['mean_hit_rate']
    assert [e['sorted_slots'] for e in tmgr.tick_log] == \
        [e['sorted_slots'] for e in jmgr.tick_log]
    assert tmgr.snapshot()['finished'] == (0, 1)


def test_admission_backlog_sheds_past_max_pending(scene):
    _, tscene = scene
    cams = [to_cam(c) for c in jax_orbit(2, width=WIDTH, height_px=WIDTH)]
    stepper = tstepper.BatchedStepper(tscene, tpipe.LuminaConfig(capacity=128),
                                      cams[0], 1, device='cpu')
    mgr = tsession.SessionManager(stepper, 1, max_pending=2)
    accepted = [mgr.submit(tsession.ViewerSession(sid=i, cams=cams))
                for i in range(3)]
    assert accepted == [True, True, False]
    assert [s.sid for s in mgr.shed] == [2]
    assert mgr.metrics['serve.shed'].value == 1
    finished = mgr.run()
    assert [s.sid for s in finished] == [0, 1]
    assert mgr.snapshot()['finished'] == (0, 1)


def test_serve_cli_renders_every_frame(capsys):
    agg = trender.main(['--device', 'cpu', '--viewers', '2', '--frames', '3',
                        '--width', '64', '--gaussians', '600'])
    out = capsys.readouterr().out
    assert agg['sessions'] == 2 and agg['frames'] == 6
    assert agg['device'] == 'cpu' and agg['mode'] == 'batched'
    assert '-- batched (reference, cpu): 2 sessions, 6 frames' in out


def test_serving_entry_points_default_to_the_card(scene, monkeypatch):
    _, tscene = scene
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cam = to_cam(jax_orbit(1, width=WIDTH, height_px=WIDTH)[0])
    cfg = tpipe.LuminaConfig(capacity=128)
    for engine in (tstepper.BatchedStepper, tstepper.SequentialStepper):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            engine(tscene, cfg, cam, 2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trender.serve(2, 3, width=64, gaussians=100)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trender.main(['--viewers', '1', '--frames', '1'])
