"""The port's slot oversubscription and lane moves against the JAX
package's, on the CPU.

* Double population (``tests/test_dropless.py``'s oracle, sync driver): 4
  pace-2 viewers on 2 physical slots; every tick's lane swaps, admissions,
  evictions, outputs and scheduler state (stash included) equal JAX's.
* Quarantine of a slot with stashed co-residents forces them through a
  fresh sort on return, as in JAX, and the run still drains.
* ``stash_lane``/``unstash_lane`` round-trip a lane exactly;
  ``plan_step(lane_swaps=)`` and ``plan_tick(advanced=)`` plan as JAX's.
* ``vacate``/``place`` and ``extract_viewer``/``restore_viewer`` (cold and
  scene-carry) against JAX's payloads and continuations.

64x64, ``structured_scene(PRNGKey(7), 800)``.
"""
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch.core import pipeline as tpipe
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                assert_outputs_match, assert_state_matches,
                                drive_pair, fix_jax_unstash, port_sessions,
                                sessions, stash_view, sync_tick, trajs)
from torch_stepper_parity import (_np, assert_images_ulp_close, make_scene,
                                  to_cam)

FRAMES = 5


@pytest.fixture(scope='module')
def scene():
    return make_scene()


@pytest.fixture(scope='module')
def steppers(scene):
    """One JAX and one port shared-scene stepper (2 slots, one scene),
    reset per test: compiling the JAX stepper dominates this file."""
    jscene, tscene = scene
    cam0 = trajs(1, 1)[0][0]
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=256, window=3), cam0, 2,
        viewers_per_scene=2)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=256, window=3), to_cam(cam0), 2,
        viewers_per_scene=2, device='cpu')
    return jst, tst


def _managers(steppers, frames=FRAMES, viewers=4):
    jst, tst = steppers
    jst.reset()
    tst.reset()
    tr = trajs(viewers, frames)
    jmgr = jsession.SessionManager(jst, 2, oversubscribe=True)
    tmgr = tsession.SessionManager(tst, 2, oversubscribe=True)
    for s in sessions(jsession.ViewerSession, tr, pace=2):
        jmgr.submit(s)
    for s in port_sessions(tsession.ViewerSession, tr, pace=2):
        tmgr.submit(s)
    return jmgr, tmgr


def test_reference_unstash_reads_a_stale_pool_index(steppers):
    """The JAX package's fault that ``fix_jax_unstash`` fixes, shown on the
    double-population schedule: at tick 8 a viewer swapped back in after
    the pool was compacted shades from device pool index 3 while its
    scheduler assigned entry 2.  The port's lane index is the scheduler's
    (checked on every tick by the parity tests)."""
    jst, _ = steppers
    jmgr, _ = _managers(steppers)
    for _ in range(8):
        sync_tick(jmgr)
    jmgr.apply_plan(jmgr.plan_tick())
    assert (np.asarray(jst.priv.pool_idx) != jst._slot_pool).any()


def test_oversubscription_serves_double_population(steppers, monkeypatch):
    fix_jax_unstash(monkeypatch)
    jmgr, tmgr = _managers(steppers)
    drive_pair(jmgr, tmgr)
    assert sorted(s.sid for s in tmgr.finished) == [0, 1, 2, 3]
    assert all(s.telemetry.frames == FRAMES for s in tmgr.finished)
    assert tmgr.metrics['serve.oversubscribed'].value == \
        jmgr.metrics['serve.oversubscribed'].value >= 2
    assert tmgr.tick <= 2 * FRAMES + 4
    assert tmgr.metrics['serve.paced_idle'].value == \
        jmgr.metrics['serve.paced_idle'].value


def test_quarantine_invalidates_stashed_coresidents(steppers, monkeypatch):
    fix_jax_unstash(monkeypatch)
    jmgr, tmgr = _managers(steppers, frames=6)
    for _ in range(4):
        sync_tick(jmgr)
        sync_tick(tmgr)
    jst, tst = jmgr.stepper, tmgr.stepper
    assert tst._stash, 'no stashed co-residents to quarantine'
    key = next(iter(tst._stash))
    slot = tst._stash[key]['slot']
    tst._stash[key]['pending_sort'] = False
    jst._stash[key]['pending_sort'] = False
    tst.quarantine(slot)
    jst.quarantine(slot)
    assert all(c['pending_sort'] for c in tst._stash.values()
               if c['slot'] == slot)
    assert_state_matches(jst, tst, 'after quarantine')
    drive_pair(jmgr, tmgr)
    assert sorted(s.sid for s in tmgr.finished) == [0, 1, 2, 3]


def test_stash_roundtrip_and_lane_swap_plan(steppers, monkeypatch):
    fix_jax_unstash(monkeypatch)
    jst, tst = steppers
    jmgr, tmgr = _managers(steppers, frames=6)
    for _ in range(3):
        sync_tick(jmgr)
        sync_tick(tmgr)
    # the stash contexts hold the lanes JAX's hold
    assert stash_view(tst) == stash_view(jst) != {}
    for key, ctx in tst._stash.items():
        jctx = jst._stash[key]
        assert int(ctx['priv'].frame_idx[0]) == int(jctx['priv'].frame_idx)
        assert int(ctx['priv'].cell_id[0]) == int(jctx['priv'].cell_id)
        np.testing.assert_array_equal(
            _np(ctx['priv'].prev_cam.position[0]),
            np.asarray(jctx['priv'].prev_cam.position))
        np.testing.assert_array_equal(_np(ctx['cam'].position[0]),
                                      np.asarray(jctx['cam'].position))
    # a lane swap's plan equals JAX's, occupant protected, incoming
    # context's cadence substituted
    key, ctx = next(iter(tst._stash.items()))
    slot = ctx['slot']
    cams_j = {slot: trajs(1, 1, start=30.0)[0][0]}
    jplan = jst.plan_step(cams_j, lane_swaps={slot: key})
    tplan = tst.plan_step({s: to_cam(c) for s, c in cams_j.items()},
                          lane_swaps={slot: key})
    assert tuple(tplan) == tuple(jplan)         # 'stream' None in both
    # plan_tick with a tick in flight reads cursors one frame further on
    for adv in ((), (0,), (0, 1)):
        jp = jmgr.plan_tick(advanced=adv)
        tp = tmgr.plan_tick(advanced=adv)
        assert (tp.evict, tp.admit, tp.switches, sorted(tp.cams)) == \
            (jp.evict, jp.admit, jp.switches, sorted(jp.cams))
        assert tuple(tp.sort_plan) == tuple(jp.sort_plan)
    # stash + unstash restores the lane exactly
    other = 1 - slot
    before = (tst.priv.frame_idx.copy(), tst.priv.cell_id.copy(),
              tst.priv.pool_idx.copy(), tst._frames_since_due.copy(),
              set(tst._pending_sort), tst.priv.prev_cam.position.clone(),
              tst._slot_cams[other].position.clone())
    tst.stash_lane(other, 'probe')
    tst.priv.frame_idx[other] = 99      # the lane is reused meanwhile
    tst.priv.prev_cam.position[other] = 0.0
    tst.unstash_lane(other, 'probe')
    after = (tst.priv.frame_idx, tst.priv.cell_id, tst.priv.pool_idx,
             tst._frames_since_due, tst._pending_sort,
             tst.priv.prev_cam.position, tst._slot_cams[other].position)
    for a, b in zip(before, after):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(a, set):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    tst.stash_lane(other, 'probe')
    with pytest.raises(ValueError):
        tst.unstash_lane(slot, 'probe')
    tst.stash_lane(other, 'gone')
    tst.drop_stash('gone')
    assert 'gone' not in tst._stash


def test_vacate_place_and_extract_restore_match_jax(steppers, monkeypatch):
    fix_jax_unstash(monkeypatch)
    jst, tst = steppers
    jmgr, tmgr = _managers(steppers, frames=6, viewers=2)
    for _ in range(3):
        sync_tick(jmgr)
        sync_tick(tmgr)
    with pytest.raises(RuntimeError):
        tmgr.place(0, tmgr.slot_session[1])          # occupied
    # the JAX payload and the port's carry the same lane
    jpay = jst.extract_viewer(1)
    tpay = tst.extract_viewer(1)
    assert (tpay['frames_since_due'], tpay['pending_sort']) == \
        (jpay['frames_since_due'], jpay['pending_sort'])
    assert tpay['shared'] is None and jpay['shared'] is None
    assert int(tpay['priv'].frame_idx[0]) == int(jpay['priv'].frame_idx)
    np.testing.assert_array_equal(_np(tpay['priv'].prev_cam.quat[0]),
                                  np.asarray(jpay['priv'].prev_cam.quat))
    np.testing.assert_array_equal(_np(tpay['cam'].position[0]),
                                  np.asarray(jpay['cam'].position))
    with pytest.raises(ValueError):
        tst.extract_viewer(1, with_scene=True)      # shared scene block
    # the viewer leaves slot 1 and comes back, cold, with its lane
    js, ts = jmgr.vacate(1), tmgr.vacate(1)
    assert ts.sid == js.sid
    with pytest.raises(RuntimeError):
        tmgr.vacate(1)
    jmgr.place(1, js, payload=jpay, admitted_tick=js.telemetry.admitted_tick)
    tmgr.place(1, ts, payload=tpay, admitted_tick=ts.telemetry.admitted_tick)
    assert_state_matches(jst, tst, 'after place')
    drive_pair(jmgr, tmgr)


def test_scene_carry_payload_matches_jax(scene):
    """Private mode: a scene-carry payload restored into the same slot of
    a reset stepper at the same tick continues bit for bit, on both
    packages."""
    jscene, tscene = scene
    tr = trajs(2, 5)
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=256, window=3), tr[0][0], 2)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=256, window=3), to_cam(tr[0][0]),
        2, device='cpu')
    for st, conv in ((jst, lambda c: c), (tst, to_cam)):
        st.admit(0)
        st.admit(1)
        for f in range(3):
            st.step({s: conv(tr[s][f]) for s in (0, 1)})
    jpay = jst.extract_viewer(1, with_scene=True)
    tpay = tst.extract_viewer(1, with_scene=True)
    tc, jc = tpay['shared']['cache'], jpay['shared'].cache
    for f in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), f)
    assert_images_ulp_close(_np(tc.values), np.asarray(jc.values),
                            err_msg='cache values')
    for k in ('pool_cell', 'pool_tick', 'pool_owner', 'refs'):
        np.testing.assert_array_equal(tpay['pool_rows'][k],
                                      jpay['pool_rows'][k], k)
    assert tpay['pool_rows']['slot_pool'] == jpay['pool_rows']['slot_pool']
    # wipe slot 1's scene, then restore the carried block
    tst.admit(1)
    tst.restore_viewer(1, tpay)
    jst.admit(1)
    jst.restore_viewer(1, jpay)
    for f in (3, 4):
        jout = jst.step({s: tr[s][f] for s in (0, 1)})
        tout = tst.step({s: to_cam(tr[s][f]) for s in (0, 1)})
        assert_outputs_match(jout, tout, f'frame {f}')
    assert_state_matches(jst, tst, 'scene carry')
