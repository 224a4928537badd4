"""The port's streaming residency (``repro_torch.serve.streaming`` and the
chunk container in ``repro_torch.data.scenes``) against the JAX package's,
on the CPU.

* ``partition_scene`` equals the JAX function array for array (packed
  fields, cells, fill, dtypes, chunk blocks); ``chunk_levels``,
  ``level_rows`` and ``masked_scene`` equal JAX's
  (``tests/test_streaming.py:120``, ``:160``).
* An arena too small for one slot raises (``:182``).
* A budgeted arena renders bit-identically to the unbounded one, with no
  stall, prefetch hits and a resident footprint below the scene (``:189``).
* The port's streamed run makes the JAX package's decisions on every
  tick: the residency plans, loads, prefetch hits, evictions, stalls, the
  arena itself, the scheduler state and the cache exactly, images within
  128 ulps x magnitude.
* Replays are deterministic, counters included (``:230``); an oversized
  union timeshares the arena and drains (``:249``), with JAX's counters;
  the threaded driver under stalls equals the sync driver, where the JAX
  package's threaded driver does not (ROADMAP queue 3).
* A checkpoint round trip at partial residency continues bit for bit, and a
  geometry mismatch is refused (``:265``, ``:332``); a JAX streaming
  snapshot carried across by ``interop`` continues as JAX does.

64x64, ``structured_scene(PRNGKey(0), 600)`` (the JAX tests' scene), cells
of 0.4, chunks of 64.
"""
import hashlib
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import pipeline as jpipe
from repro.data import scenes as jscenes
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import session as jsession
from repro.serve import stepper as jstepper
from repro.serve import streaming as jstreaming

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as tpipe
from repro_torch.data import scenes as tscenes
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from repro_torch.serve import streaming as tstreaming
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                assert_outputs_match, assert_plans_match,
                                assert_state_matches, port_sessions,
                                sessions, sync_tick)
from torch_stepper_parity import _np, assert_images_ulp_close, to_cam

WIDTH = 64
CELL = 0.4
CAP = 64
FRAME_BYTES = CAP * jscenes.BYTES_PER_GAUSSIAN


@pytest.fixture(scope='module')
def scene():
    jscene = jscenes.structured_scene(jax.random.PRNGKey(0), 600)
    return jscene, interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                            device='cpu')


@pytest.fixture(scope='module')
def chunked(scene):
    jch = jscenes.partition_scene(scene[0], cell_size=CELL, chunk_cap=CAP)
    tch = tscenes.partition_scene(scene[1], cell_size=CELL, chunk_cap=CAP)
    return jch, tch


def _residency(pkg, ch, budget_frames=None, **kw):
    budget = None if budget_frames is None else budget_frames * FRAME_BYTES
    kw.setdefault('near_radius', 3)
    kw.setdefault('lod_radius', 5)
    if pkg == 'jax':
        return jstreaming.ResidencyManager(ch, budget_bytes=budget, **kw)
    return tstreaming.ResidencyManager(ch, budget_bytes=budget,
                                       device='cpu', **kw)


def _trajs(viewers, frames, deg_step):
    return [jax_orbit(frames, width=WIDTH, height_px=WIDTH,
                      start_deg=deg_step * sid) for sid in range(viewers)]


def _build(pkg, scene, res, viewers):
    cam0 = jax_orbit(1, width=WIDTH, height_px=WIDTH)[0]
    if pkg == 'jax':
        st = jstepper.BatchedStepper(
            scene[0], jpipe.LuminaConfig(capacity=192, window=3), cam0,
            viewers, streaming=res)
        return st, jsession
    st = tstepper.BatchedStepper(
        scene[1], tpipe.LuminaConfig(capacity=192, window=3), to_cam(cam0),
        viewers, streaming=res, device='cpu')
    return st, tsession


def _serve(pkg, scene, res, *, viewers=2, frames=6, deg_step=40.0,
           driver='sync', max_ticks=300, kill_at=None, ckpt=None,
           stepper=None):
    """A streamed serving run; returns ``(manager, stepper, {(sid, cursor):
    image})`` as ``tests/test_streaming.py::_serve`` does.  ``stepper``
    (reset first) is one built over ``res`` already."""
    if stepper is None:
        st, session = _build(pkg, scene, res, viewers)
    else:
        st, session = stepper, (jsession if pkg == 'jax' else tsession)
        st.reset()
    sm = session.SessionManager(st, viewers)
    if ckpt is not None:
        sm.enable_checkpoints(ckpt, every=3)
    make = sessions if pkg == 'jax' else port_sessions
    for s in make(session.ViewerSession, _trajs(viewers, frames, deg_step),
                  arrival_tick=list(range(viewers))):
        sm.submit(s)
    outs = {}
    orig = sm.observe_tick

    def observing(plan, outputs, *a, **k):
        for slot, out in outputs.items():
            sess = sm.slot_session[slot]
            if sess is not None:
                outs[(sess.sid, sess.cursor)] = _np(out[0])
        return orig(plan, outputs, *a, **k)

    sm.observe_tick = observing
    if driver == 'threaded':
        sm.run(driver='threaded', max_ticks=max_ticks)
        return sm, st, outs
    t = 0
    while not sm.drained() and t < max_ticks:
        sm.run_tick()
        sm.evict_finished()
        if ckpt is not None:
            sm.maybe_checkpoint()
        t += 1
        if kill_at is not None and sm.tick >= kill_at:
            break
    return sm, st, outs


def _assert_frames(got, want, exact, what=''):
    assert set(got) == set(want) and want, what
    for key in want:
        if exact:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f'{what} frame {key}')
        else:
            assert_images_ulp_close(got[key], want[key],
                                    err_msg=f'{what} frame {key}')


@pytest.fixture(scope='module')
def jax_budgeted(scene, chunked):
    """The JAX package's budgeted run (63 frames): counters and frames."""
    res = _residency('jax', chunked[0], budget_frames=63)
    sm, _, outs = _serve('jax', scene, res)
    assert sm.drained()
    return res.counters(), sm.tick, outs


@pytest.fixture(scope='module')
def jax_trickle(scene, chunked):
    """A JAX stepper streaming through 63 frames at 4 loads a tick (reset
    per run: compiling it dominates this file)."""
    res = _residency('jax', chunked[0], budget_frames=63,
                     max_loads_per_tick=4)
    return res, _build('jax', scene, res, 2)[0]


# -- the partition ------------------------------------------------------------

@pytest.mark.parametrize('n,cell,cap', [(600, 0.4, 64), (600, 0.1, 8),
                                        (599, 0.05, 3), (1, 0.4, 64)])
def test_partition_equals_jax(scene, n, cell, cap):
    js = jax.tree.map(lambda x: x[:n], scene[0])
    host = tscenes.SceneArrays(*(np.asarray(x) for x in js))
    want = jscenes.partition_scene(js, cell_size=cell, chunk_cap=cap)
    got = tscenes.partition_scene(host, cell_size=cell, chunk_cap=cap)
    from_tensors = tscenes.partition_scene(
        interop.scene_from_numpy(*host, device='cpu'), cell_size=cell,
        chunk_cap=cap)
    for ch in (got, from_tensors):
        assert ch.num_chunks == want.num_chunks
        assert ch.meta_dict() == want.meta_dict()
        assert ch.scene_bytes == want.scene_bytes == tscenes.scene_nbytes(n)
        for a, b in ((ch.cells, want.cells), (ch.fill, want.fill),
                     *zip(ch.packed, want.packed)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for c in sorted({0, want.num_chunks // 2, want.num_chunks - 1}):
        for rows, keep in ((cap, None), (max(1, cap // 2), 1), (cap, 0)):
            for a, b in zip(got.chunk_block(c, rows, keep),
                            want.chunk_block(c, rows, keep)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_levels_and_masked_scene_equal_jax(chunked):
    jch, tch = chunked
    n = jch.num_chunks
    cams = _trajs(3, 2, 120.0)
    positions = [np.asarray(c.position) for traj in cams for c in traj]
    for near, lod in ((0, 1), (2, 4), (3, 5)):
        np.testing.assert_array_equal(
            tscenes.chunk_levels(tch, positions, near, lod),
            jscenes.chunk_levels(jch, positions, near, lod))
    for level in (tscenes.LEVEL_ABSENT, tscenes.LEVEL_LOD,
                  tscenes.LEVEL_FULL):
        for frac in (0.5, 0.3):
            levels = np.full((n,), level)
            np.testing.assert_array_equal(
                tscenes.level_rows(tch, levels, frac),
                jscenes.level_rows(jch, levels, frac))
    lod = tscenes.level_rows(tch, np.full((n,), tscenes.LEVEL_LOD), 0.5)
    assert (lod[tch.fill > 0] >= 1).all() and (lod <= tch.fill).all()
    rng = np.random.default_rng(0)
    arena = tscenes.SceneArrays(*(torch.from_numpy(x.copy())
                                  for x in tch.packed))
    for rows in (tch.fill, np.zeros((n,), np.int64),
                 rng.integers(0, CAP + 1, size=n)):
        got = tscenes.masked_scene(arena, rows, CAP)
        want = jscenes.masked_scene(jch.packed, rows, CAP)
        for f in tscenes.SceneArrays._fields:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)), f)


def test_arena_too_small_raises(chunked):
    cam = jax_orbit(1, width=WIDTH, height_px=WIDTH)[0]
    msgs = []
    for pkg, ch, c in (('jax', chunked[0], cam), ('port', chunked[1],
                                                  to_cam(cam))):
        with pytest.raises(RuntimeError, match='arena too small') as e:
            _residency(pkg, ch, budget_frames=2).plan(0, {0: c})
        msgs.append(str(e.value).split(';')[0].split(' —')[0])
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize('budget_frames,max_loads', [(80, 3), (None, None)])
def test_plans_equal_jax_on_a_random_walk(scene, budget_frames, max_loads):
    """Residency alone, plan and apply, on a seeded walk of three cameras
    over a fine partition (cells of 0.2, chunks of 8): every plan (loads,
    prefetch, evictions, stalls, mask, hits) equals the JAX package's, and
    the mirrors, counters and arena stay equal; the tight budget evicts and
    stalls."""
    jch = jscenes.partition_scene(scene[0], cell_size=0.2, chunk_cap=8)
    tch = tscenes.partition_scene(scene[1], cell_size=0.2, chunk_cap=8)
    kw = dict(near_radius=1, lod_radius=3, grace_ticks=2,
              max_loads_per_tick=max_loads,
              budget_bytes=(None if budget_frames is None
                            else budget_frames * 8 * jscenes.BYTES_PER_GAUSSIAN))
    jm = jstreaming.ResidencyManager(jch, **kw)
    tm = tstreaming.ResidencyManager(tch, device='cpu', **kw)
    rng = np.random.default_rng(3)
    angle = rng.uniform(0, 360, 3)
    for tick in range(30):
        angle += rng.uniform(0, 40, 3)
        live = [s for s in range(3) if rng.random() < 0.8]
        jcams = {s: jax_orbit(1, width=WIDTH, height_px=WIDTH,
                              radius=float(rng.uniform(0.6, 1.6)),
                              start_deg=float(angle[s]))[0] for s in live}
        admits = frozenset(s for s in live if rng.random() < 0.2)
        want = jm.plan(tick, jcams, admits)
        got = tm.plan(tick, {s: to_cam(c) for s, c in jcams.items()}, admits)
        assert got == want, f'tick {tick}'
        jm.apply(want)
        tm.apply(got)
        assert tm.counters() == jm.counters(), f'tick {tick}'
        for name in ('_loaded', '_prefetched', '_last_required',
                     '_slot_chunk', '_mask_rows'):
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name), name)
    for a, b in zip(tm._arena, jm._arena):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    c = tm.counters()
    if budget_frames is not None:
        assert c['evictions'] > 0 and c['stalls'] > 0
    assert c['prefetch_hits'] > 0


# -- serving ------------------------------------------------------------------

def test_budget_bit_identity_and_counters(scene, chunked, jax_budgeted):
    runs = {}
    for name, frames_budget in (('lim', 63), ('full', None)):
        res = _residency('port', chunked[1], budget_frames=frames_budget)
        sm, _, outs = _serve('port', scene, res)
        assert sm.drained()
        runs[name] = (res, outs, sm.tick)
    lim, full = runs['lim'][0], runs['full'][0]
    _assert_frames(runs['lim'][1], runs['full'][1], exact=True,
                   what='budgeted vs unbounded')
    counters = lim.counters()
    assert counters['stalls'] == 0
    assert counters['prefetch_hits'] > 0
    assert lim.arena_slots < full.arena_slots
    assert 0 < lim.resident_bytes < lim.chunked.scene_bytes
    jcounters, jticks, jouts = jax_budgeted
    assert counters == jcounters and runs['lim'][2] == jticks
    _assert_frames(runs['lim'][1], jouts, exact=False, what='port vs JAX')


def _pair(scene, chunked, jax_trickle):
    """The JAX and a port streamed manager (63 frames, 4 loads a tick) on
    the same sessions."""
    jres, jst = jax_trickle
    jst.reset()
    tres = _residency('port', chunked[1], budget_frames=63,
                      max_loads_per_tick=4)
    out = []
    for res, st, session, make in (
            (jres, jst, jsession, sessions),
            (tres, _build('port', scene, tres, 2)[0], tsession,
             port_sessions)):
        mgr = session.SessionManager(st, 2)
        for s in make(session.ViewerSession, _trajs(2, 6, 40.0),
                      arrival_tick=[0, 1]):
            mgr.submit(s)
        out += [res, mgr]
    return out


def _drive_stream_pair(jres, jmgr, tres, tmgr, max_ticks=64):
    """Tick by tick until both drain: plans (residency included), outputs,
    stepper state, counters and the arena equal."""
    jst, tst = jmgr.stepper, tmgr.stepper
    while not (jmgr.drained() and tmgr.drained()):
        t = jmgr.tick
        jplan, jout = sync_tick(jmgr)
        tplan, tout = sync_tick(tmgr)
        msg = f'tick {t}'
        assert_plans_match(jplan, tplan, msg)
        if jplan.sort_plan is not None:
            assert tplan.sort_plan.stream == jplan.sort_plan.stream, msg
        assert_outputs_match(jout, tout, msg)
        assert_state_matches(jst, tst, msg)
        assert tres.counters() == jres.counters(), msg
        assert tres.resident_bytes == jres.resident_bytes, msg
        for a, b in zip(tres._arena, jres._arena):
            np.testing.assert_array_equal(_np(a), np.asarray(b), msg)
        assert jmgr.tick < max_ticks, 'serve loop did not drain'
    assert tmgr.tick == jmgr.tick


def test_streamed_run_equals_jax_per_tick(scene, chunked, jax_trickle):
    jres, jmgr, tres, tmgr = _pair(scene, chunked, jax_trickle)
    _drive_stream_pair(jres, jmgr, tres, tmgr)
    c = tres.counters()
    assert c['loads'] > 0 and c['prefetch_hits'] > 0
    for key, name in (('stream_loads', 'loads'),
                      ('stream_prefetch_hits', 'prefetch_hits'),
                      ('stream_stalls', 'stalls'),
                      ('stream_evictions', 'evictions')):
        assert tmgr.tick_log[-1][key] == c[name]
    assert tmgr.metrics['stream.loads'].value == c['loads']


def test_replay_determinism_including_prefetch_hits(scene, chunked,
                                                    jax_budgeted):
    results = []
    for _ in range(2):
        res = _residency('port', chunked[1], budget_frames=63)
        sm, _, outs = _serve('port', scene, res)
        assert sm.drained()
        results.append((res.counters(), sm.tick, outs))
    (c1, t1, o1), (c2, t2, o2) = results
    assert c1 == c2 == jax_budgeted[0] and c1['prefetch_hits'] > 0
    assert t1 == t2
    _assert_frames(o1, o2, exact=True, what='replay')


def _digests(outs):
    return {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in outs.items()}


def test_timeshare_drains_and_threaded_stalls(scene, chunked):
    """Three viewers whose union working set exceeds the arena: the
    rotated reservation timeshares it and every viewer drains, with the JAX
    package's counters and frames.  The port's threaded driver, whose
    worker advances only the slots that render, makes the sync driver's
    decisions under these stalls; the JAX package's threaded driver also
    advances the stalled slots' cursors in its plan for the next tick, and
    renders other frames than its own sync driver (ROADMAP queue 3)."""
    runs = {}
    for pkg, ch in (('jax', chunked[0]), ('port', chunked[1])):
        res = _residency(pkg, ch, budget_frames=70)
        st = _build(pkg, scene, res, 3)[0]
        for driver in ('sync', 'threaded'):
            with warnings.catch_warnings():
                warnings.simplefilter('ignore', RuntimeWarning)
                sm, _, outs = _serve(pkg, scene, res, viewers=3,
                                     deg_step=120.0, max_ticks=400,
                                     driver=driver, stepper=st)
            assert sm.drained(), (pkg, driver)
            for sid in range(3):
                assert sum(1 for k in outs if k[0] == sid) == 6
            runs[pkg, driver] = (res.counters(), sm.tick, outs)
    counters, ticks, outs = runs['port', 'sync']
    assert counters['stalls'] > 0 and counters['evictions'] > 0
    assert (counters, ticks) == runs['jax', 'sync'][:2]
    _assert_frames(outs, runs['jax', 'sync'][2], exact=False,
                   what='port vs JAX')
    assert runs['port', 'threaded'][:2] == (counters, ticks)
    _assert_frames(runs['port', 'threaded'][2], outs, exact=True,
                   what='threaded vs sync')
    # the reference's fault, pinned: its threaded frames differ from its
    # sync frames once a slot stalls
    assert _digests(runs['jax', 'threaded'][2]) != \
        _digests(runs['jax', 'sync'][2])


def test_checkpoint_roundtrip_partial_residency(scene, chunked, tmp_path):
    kw = dict(budget_frames=63, max_loads_per_tick=4)
    tch = chunked[1]
    res_g = _residency('port', tch, **kw)
    _, _, golden = _serve('port', scene, res_g)
    victim = _residency('port', tch, **kw)
    sm_v, _, _ = _serve('port', scene, victim,
                        ckpt=CheckpointManager(tmp_path, keep=5), kill_at=4)
    assert not sm_v.drained()
    sm_v._ckpt.wait()

    res = _residency('port', tch, **kw)
    st, _ = _build('port', scene, res, 2)
    sm = tsession.SessionManager(st, 2)
    restored = sm.restore_serving(
        CheckpointManager(tmp_path),
        port_sessions(tsession.ViewerSession, _trajs(2, 6, 40.0),
                      arrival_tick=[0, 1]))
    assert restored == 3
    assert 0 < (res._loaded > 0).sum() < tch.num_chunks
    c0 = res.counters()
    outs = {}
    orig = sm.observe_tick

    def observing(plan, outputs, *a, **k):
        for slot, out in outputs.items():
            outs[(sm.slot_session[slot].sid,
                  sm.slot_session[slot].cursor)] = _np(out[0])
        return orig(plan, outputs, *a, **k)

    sm.observe_tick = observing
    sm.run()
    c1 = res.counters()
    assert c1['loads'] + c1['prefetch'] > c0['loads'] + c0['prefetch']
    assert outs
    for key, img in outs.items():
        np.testing.assert_array_equal(img, golden[key],
                                      err_msg=f'frame {key} after restore')
    assert res.resident_bytes == res_g.resident_bytes

    # a snapshot of one partition refused by another, in both packages
    other = jscenes.structured_scene(jax.random.PRNGKey(2), 400)
    for pkg, ch, other_ch in (
            ('port', tch, tscenes.partition_scene(
                tscenes.SceneArrays(*(np.asarray(x) for x in other)),
                cell_size=CELL, chunk_cap=CAP)),
            ('jax', chunked[0], jscenes.partition_scene(
                other, cell_size=CELL, chunk_cap=CAP))):
        arrays, meta = _residency(pkg, ch).state_dict()
        with pytest.raises(ValueError, match='geometry mismatch'):
            _residency(pkg, other_ch).load_state(arrays, meta)


def test_jax_streaming_snapshot_carried_across(scene, chunked, jax_trickle,
                                               tmp_path):
    """A JAX streamed run at partial residency, checkpointed by the JAX
    package at tick 3, loads into the port through
    ``interop.serving_state_from_numpy`` (the partition through
    ``chunked_scene_from_numpy``) and continues with JAX's decisions."""
    jres, jmgr, _, _ = _pair(scene, chunked, jax_trickle)
    jmgr.enable_checkpoints(JCheckpointManager(tmp_path), every=3)
    while jmgr.tick < 3:
        sync_tick(jmgr)
        jmgr.maybe_checkpoint()
    jmgr._ckpt.wait()
    jst = jmgr.stepper
    jarrays, jmeta = jst.state_dict()
    assert 0 < (jres._loaded > 0).sum() < jres.chunked.num_chunks
    arrays, meta = interop.serving_state_from_numpy(
        jax.tree.map(np.asarray, jarrays), jmeta, device='cpu')

    jch = chunked[0]
    tch = interop.chunked_scene_from_numpy(
        jch.packed, jch.cells, jch.fill, jch.cell_size, jch.chunk_cap,
        jch.source_count)
    tres = _residency('port', tch, budget_frames=63, max_loads_per_tick=4)
    tst, _ = _build('port', scene, tres, 2)
    tst.load_state(arrays, meta)
    assert tst.state_dict()[1] == jmeta
    for a, b in zip(tres._arena, jres._arena):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    tmgr = tsession.SessionManager(tst, 2)
    by_sid = {s.sid: s for s in port_sessions(
        tsession.ViewerSession, _trajs(2, 6, 40.0), arrival_tick=[0, 1])}
    tmgr.tick = jmgr.tick
    tmgr.slot_session = [None if s is None else by_sid[s.sid]
                         for s in jmgr.slot_session]
    for s in jmgr.slot_session:
        if s is not None:
            by_sid[s.sid].cursor = s.cursor
            by_sid[s.sid].telemetry.admitted_tick = s.telemetry.admitted_tick
    tst.sort_log = list(jst.sort_log)
    _drive_stream_pair(jres, jmgr, tres, tmgr)
