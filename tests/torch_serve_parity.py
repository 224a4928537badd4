"""Shared helpers of the serving-state parity tests
(``test_torch_oversub.py``, ``test_torch_faults.py``,
``test_torch_checkpoint.py``): the JAX package's ``SessionManager`` and the
port's are driven tick by tick as the sync driver drives them, and each
tick's plan (evictions, admissions, lane swaps), outputs (sorted flags, hit
rates, ``saved_frac``, images within 128 ulps x magnitude) and the
steppers' scheduler state (pool cell/refs/tick, each slot's entry,
``frames_since_due``, ``pending_sort``, the stash) and cache tags/age/clock
must agree."""
import numpy as np
import pytest
import torch

from repro.data.trajectory import orbit_trajectory as jax_orbit

from torch_stepper_parity import (WIDTH, _np, assert_images_ulp_close,
                                  to_cam)


def trajs(n, frames, spread=85.0, start=7.0):
    """JAX orbits at distinct start angles (distinct pose cells)."""
    return [jax_orbit(frames, width=WIDTH, height_px=WIDTH,
                      start_deg=spread * i + start) for i in range(n)]


def sessions(session_cls, trajectories, convert=None, **kw):
    """One session per trajectory; ``convert`` maps JAX cameras to the
    port's.  ``kw`` values that are sequences give one value per sid."""
    out = []
    for sid, traj in enumerate(trajectories):
        opts = {k: (v[sid] if isinstance(v, (list, tuple)) else v)
                for k, v in kw.items()}
        cams = traj if convert is None else [convert(c) for c in traj]
        out.append(session_cls(sid=sid, cams=cams, **opts))
    return out


def port_sessions(session_cls, trajectories, **kw):
    return sessions(session_cls, trajectories, to_cam, **kw)


def sync_tick(mgr):
    """One tick of the sync driver, returning ``(plan, outputs)``."""
    plan = mgr.plan_tick_hardened()
    mgr.apply_plan(plan)
    outputs, _poisoned = mgr.step_hardened(plan)
    mgr.observe_tick(plan, outputs)
    mgr.evict_finished()
    return plan, outputs


def stash_view(stepper):
    return {k: (ctx['slot'], bool(ctx['pending_sort']),
                int(ctx['slot_pool']), int(ctx['frames_since_due']))
            for k, ctx in stepper._stash.items()}


def assert_state_matches(jst, tst, msg=''):
    """The two ``BatchedStepper``s' scheduler state and cache."""
    assert tst.global_tick == jst.global_tick, msg
    assert tst.pool_cap == jst.pool_cap, msg
    for want, got, name in (
            (jst._pool_cell, tst.shared.pool_cell, 'pool_cell'),
            (jst._refs, tst.shared.pool_refs, 'pool_refs'),
            (jst._pool_tick, tst.shared.pool_tick, 'pool_tick'),
            (jst._pool_owner, tst._pool_owner, 'pool_owner'),
            (jst._slot_pool, tst.priv.pool_idx, 'slot_pool'),
            (jst._frames_since_due, tst._frames_since_due,
             'frames_since_due')):
        np.testing.assert_array_equal(got, want, f'{msg}: {name}')
    assert tst._pending_sort == jst._pending_sort, msg
    assert tst._resident == jst._resident, msg
    assert stash_view(tst) == stash_view(jst), msg
    assert tst.sort_log == jst.sort_log, msg
    for f in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(
            _np(getattr(tst.shared.cache, f)),
            np.asarray(getattr(jst.shared.cache, f)), f'{msg}: cache {f}')


def assert_outputs_match(jout, tout, msg=''):
    assert sorted(tout) == sorted(jout), msg
    for slot in jout:
        img_j, st_j, _ = jout[slot]
        img_t, st_t, _ = tout[slot]
        m = f'{msg} slot {slot}'
        assert float(st_t.sorted_this_frame) == \
            float(st_j.sorted_this_frame), m
        assert float(st_t.hit_rate) == float(st_j.hit_rate), m
        assert float(st_t.saved_frac) == float(st_j.saved_frac), m
        assert_images_ulp_close(_np(img_t), np.asarray(img_j), err_msg=m)


def assert_plans_match(jplan, tplan, msg=''):
    for f in ('tick', 'evict', 'admit', 'switches'):
        assert getattr(tplan, f) == getattr(jplan, f), f'{msg}: {f}'
    assert sorted(tplan.cams) == sorted(jplan.cams), msg


def drive_pair(jmgr, tmgr, max_ticks=64, each=None):
    """Drive both managers tick by tick until both drain, holding every
    tick's plan, outputs and stepper state equal.  ``each(tick)`` runs
    after each tick's comparison."""
    while not (jmgr.drained() and tmgr.drained()):
        t = jmgr.tick
        jplan, jout = sync_tick(jmgr)
        tplan, tout = sync_tick(tmgr)
        msg = f'tick {t}'
        assert_plans_match(jplan, tplan, msg)
        assert_outputs_match(jout, tout, msg)
        assert_state_matches(jmgr.stepper, tmgr.stepper, msg)
        if each is not None:
            each(t)
        assert jmgr.tick < max_ticks, 'serve loop did not drain'
    assert tmgr.tick == jmgr.tick
    assert [s.sid for s in tmgr.finished] == [s.sid for s in jmgr.finished]
    assert [s.telemetry.finished_tick for s in tmgr.finished] == \
        [s.telemetry.finished_tick for s in jmgr.finished]


def fix_jax_unstash(monkeypatch):
    """Hold parity against the JAX package's stepper with one fault of its
    own fixed for the test (ROADMAP queue 3): its ``unstash_lane`` writes
    the parked lane's own pool index into the device lane, and
    ``_resize_pool`` remaps a parked context's host entry (``slot_pool``)
    but not that lane copy, so after a pool resize the swapped-in viewer
    shades from another pose cell's entry.  The port keeps one index per
    slot; here the JAX device lane is set from its host mirror after each
    unstash, as the reference's docstring intends."""
    import dataclasses

    import jax.numpy as jnp
    from repro.serve import stepper as jstepper

    orig = jstepper.BatchedStepper.unstash_lane

    def unstash_lane(self, slot, key):
        orig(self, slot, key)
        self.priv = dataclasses.replace(
            self.priv, pool_idx=self.priv.pool_idx.at[slot].set(
                jnp.int32(self._slot_pool[slot])))

    monkeypatch.setattr(jstepper.BatchedStepper, 'unstash_lane',
                        unstash_lane)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Run a module's port code on one intra-op thread.  The tensors are
    64-px small, so one thread is as fast alone, and the parallel test
    workers then do not oversubscribe the cores with spinning threads
    (which slowed these modules by an order of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
