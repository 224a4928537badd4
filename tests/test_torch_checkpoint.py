"""The port's checkpoints and serving-state snapshots, on the CPU.

* ``repro_torch.checkpoint``: the manager protocol of
  ``tests/test_checkpoint.py`` (round trip, atomic publish, partial and
  corrupt checkpoints skipped, keep-K, ``keep_every``, async save, structure
  mismatch) and ``tests/test_chaos.py``'s checksum fallback, on trees of
  tensors, numpy arrays, dicts, lists, tuples and dataclasses; a tensor
  mutated in place after ``save()`` returns is saved as it was.
* ``state_dict``/``load_state`` round-trip a stepper exactly (both
  engines), and a run killed mid-way and restored from its newest
  checkpoint continues bit for bit (both port backends; the grown pool with
  stashed lanes of ``tests/test_dropless.py``).
* A JAX ``BatchedStepper.state_dict()`` carried across by
  ``interop.serving_state_from_numpy``: the port's meta equals JAX's key for
  key, its arrays equal JAX's by meaning, and the continuation makes JAX's
  decisions.
* The CLI's ``--checkpoint-dir``/``--checkpoint-every``/``--restore`` and
  ``--faults``.

64x64, ``structured_scene(PRNGKey(7), 800)``.
"""
import dataclasses
import warnings
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch import interop
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import pipeline as tpipe
from repro_torch.serve import render as trender
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                assert_state_matches, drive_pair,
                                fix_jax_unstash, port_sessions, sessions,
                                sync_tick, trajs)
from torch_stepper_parity import _np, make_scene, to_cam

ARRIVALS = (0, 0, 1, 6, 9)


@dataclasses.dataclass(frozen=True)
class _Pair:
    a: torch.Tensor
    tag: str = 'static'


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {'w': torch.randn(8, 4, generator=g),
            'opt': {'mu': torch.zeros(8, 4), 'step': torch.tensor(seed),
                    'host': np.arange(6, dtype=np.int64) * seed},
            'seq': [torch.full((3,), float(seed)),
                    (_Pair(torch.ones(2, 2) * seed),)]}


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif dataclasses.is_dataclass(want):
        assert type(got) is type(want)
        for f in dataclasses.fields(want):
            _assert_trees_equal(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# -- the manager protocol ---------------------------------------------------

def test_roundtrip(tmp_path):
    tree = _tree(3)
    save_checkpoint(tmp_path, tree, step=7, extra={'note': 'hi'})
    got, extra = load_checkpoint(tmp_path, _tree(0), step=7)
    _assert_trees_equal(got, tree)
    assert extra['note'] == 'hi'


def test_atomic_no_tmp_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_tree(), step=1)
    mgr.wait()
    assert not any(p.name.endswith('.tmp') for p in Path(tmp_path).iterdir())
    assert mgr.latest() == 1


def test_partial_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_tree(1), step=1)
    mgr.wait()
    bad = Path(tmp_path) / 'step_0000000002.tmp'
    bad.mkdir()
    (bad / 'host0.npz').write_bytes(b'garbage')
    assert mgr.latest() == 1
    out = mgr.restore_latest(_tree(0))
    assert out is not None and out[1] == 1


def test_corrupt_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(_tree(1), step=1)
    mgr.wait()
    mgr.save(_tree(2), step=2)
    mgr.wait()
    (Path(tmp_path) / 'step_0000000002' / 'host0.npz').write_bytes(b'junk')
    with pytest.warns(RuntimeWarning, match='unreadable'):
        tree, step, _ = mgr.restore_latest(_tree(0))
    assert step == 1
    _assert_trees_equal(tree, _tree(1))


def test_checksum_mismatch_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(_tree(1), step=1)
    mgr.wait()
    mgr.save(_tree(2), step=2)
    mgr.wait()
    shard = tmp_path / 'step_0000000002' / 'host0.npz'
    with np.load(shard) as z:
        arrs = {k: z[k] for k in z.files}
    k0 = sorted(arrs)[-1]
    arrs[k0] = arrs[k0] + 17.0
    with open(shard, 'wb') as f:
        np.savez(f, **arrs)
    with pytest.warns(RuntimeWarning, match='checksum mismatch'):
        restored, step, _ = mgr.restore_latest(_tree(0))
    assert step == 1
    _assert_trees_equal(restored, _tree(1))
    assert mgr.metrics['ckpt.restore_fallback'].value == 1


@pytest.mark.parametrize('keep,keep_every,left', [(2, 0, [4, 5]),
                                                  (1, 2, [2, 4, 5])])
def test_keep_k_gc(tmp_path, keep, keep_every, left):
    mgr = CheckpointManager(tmp_path, keep=keep, keep_every=keep_every)
    for s in range(1, 6):
        mgr.save(_tree(s), step=s)
        mgr.wait()
    assert mgr.all_steps() == left


def test_async_save_copies_before_returning(tmp_path):
    """``save()`` returns once its host copy is made: in-place writes to
    the live tensors after that (as the next serving tick makes) are not
    in the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree(9)
    want = _tree(9)
    mgr.save(tree, step=3)          # async
    tree['w'].add_(100.0)
    tree['opt']['host'][:] = -1
    tree['seq'][1][0].a.zero_()
    mgr.wait()
    got, step, _ = mgr.restore_latest(_tree(0))
    assert step == 3
    _assert_trees_equal(got, want)


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=1)
    with pytest.raises(ValueError):
        load_checkpoint(tmp_path, {'different': torch.zeros(3)}, step=1)
    bigger = _tree()
    bigger['w'] = torch.zeros(9, 4)
    with pytest.raises(ValueError, match='shape mismatch'):
        load_checkpoint(tmp_path, bigger, step=1)


# -- serving-state snapshots -------------------------------------------------

@pytest.fixture(scope='module')
def scene():
    return make_scene()


def _private_sessions(frames=3):
    tr = trajs(len(ARRIVALS), frames, spread=72.0, start=0.0)
    return port_sessions(tsession.ViewerSession, tr, arrival_tick=ARRIVALS)


class TickRecorder:
    """Records each tick's images and sort-log entry, keyed by the
    stepper's ``global_tick`` (which a restore carries over)."""

    def __init__(self, stepper):
        self._s = stepper
        self.ticks = {}

    def __getattr__(self, name):
        return getattr(self._s, name)

    def step_dispatch(self, cams, plan=None):
        return self._s.step_dispatch(cams, plan)

    def step_finish(self, infl):
        tick = self._s.global_tick - 1
        out = self._s.step_finish(infl)
        self.ticks[tick] = ({s: o[0].clone() for s, o in out.items()},
                            dict(self._s.sort_log[-1]))
        return out


def _assert_ticks_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for t in want:
        assert got[t][1] == want[t][1], f'tick {t} sort log'
        assert got[t][0].keys() == want[t][0].keys(), f'tick {t}'
        for s in want[t][0]:
            assert torch.equal(got[t][0][s], want[t][0][s]), f'tick {t} {s}'


def _cache(stepper):
    c = stepper.shared.cache
    return [x.clone() for x in (c.tags, c.age, c.clock)]


@pytest.mark.parametrize('backend', ['reference', 'kernel'])
def test_kill_and_restore_bitwise(scene, backend, tmp_path):
    _, tscene = scene
    cfg = tpipe.LuminaConfig(capacity=192, window=3, backend=backend)
    stepper = tstepper.BatchedStepper(tscene, cfg,
                                      _private_sessions()[0].cams[0], 2,
                                      device='cpu')
    rec = TickRecorder(stepper)
    mgr = tsession.SessionManager(rec, 2)
    for s in _private_sessions():
        mgr.submit(s)
    mgr.run()
    golden, golden_cache, total = dict(rec.ticks), _cache(stepper), mgr.tick

    stepper.reset()
    mgr = tsession.SessionManager(stepper, 2)
    ckpt = CheckpointManager(tmp_path, keep=3)
    mgr.enable_checkpoints(ckpt, every=4)
    for s in _private_sessions():
        mgr.submit(s)
    while not mgr.drained() and mgr.tick < 9:
        sync_tick(mgr)
        mgr.maybe_checkpoint()
    assert not mgr.drained(), 'the kill must land mid-run'
    ckpt.wait()

    stepper.reset()
    rec = TickRecorder(stepper)
    mgr = tsession.SessionManager(rec, 2)
    assert mgr.restore_serving(CheckpointManager(tmp_path),
                               _private_sessions()) == 8
    assert mgr.tick == 8
    mgr.run()
    assert mgr.metrics['serve.restores'].value == 1
    _assert_ticks_equal(rec.ticks, {t: v for t, v in golden.items()
                                    if t >= 8})
    assert mgr.tick == total
    for got, want in zip(_cache(stepper), golden_cache):
        assert torch.equal(got, want)


def _oversub(tscene, frames=8):
    tr = trajs(4, frames)
    stepper = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=256, window=3),
        to_cam(tr[0][0]), 2, viewers_per_scene=2, device='cpu')
    mgr = tsession.SessionManager(stepper, 2, oversubscribe=True)
    return mgr, stepper, port_sessions(tsession.ViewerSession, tr, pace=2)


def test_checkpoint_roundtrip_at_grown_capacity(scene, tmp_path):
    _, tscene = scene
    mgr, stepper, ss = _oversub(tscene)
    rec = TickRecorder(stepper)
    mgr.stepper = rec
    for s in ss:
        mgr.submit(s)
    mgr.run()
    golden, golden_cache, total = dict(rec.ticks), _cache(stepper), mgr.tick

    mgr, stepper, ss = _oversub(tscene)
    mgr.enable_checkpoints(CheckpointManager(tmp_path, keep=5), every=3)
    for s in ss:
        mgr.submit(s)
    while not mgr.drained() and mgr.tick < 7:
        sync_tick(mgr)
        mgr.maybe_checkpoint()
    mgr._ckpt.wait()
    assert stepper.pool_cap > 1 and stepper._stash

    mgr, stepper, ss = _oversub(tscene)
    assert stepper.pool_cap == 1
    rec = TickRecorder(stepper)
    mgr.stepper = rec
    assert mgr.restore_serving(CheckpointManager(tmp_path), ss) == 6
    assert stepper.pool_cap > 1, 'restore must adopt the snapshot geometry'
    mgr.run()
    assert sorted(s.sid for s in mgr.finished) == [0, 1, 2, 3]
    assert mgr.tick == total
    _assert_ticks_equal(rec.ticks, {t: v for t, v in golden.items()
                                    if t >= 6})
    for got, want in zip(_cache(stepper), golden_cache):
        assert torch.equal(got, want)


def test_state_dict_roundtrip_is_exact(scene):
    """Both engines: a snapshot restored into a reset stepper gives back the
    same snapshot and the same next frames."""
    _, tscene = scene
    tr = trajs(2, 4, spread=72.0, start=0.0)
    cams = [[to_cam(c) for c in t] for t in tr]
    cfg = tpipe.LuminaConfig(capacity=192, window=3)
    for st in (tstepper.BatchedStepper(tscene, cfg, cams[0][0], 2,
                                       device='cpu'),
               tstepper.SequentialStepper(tscene, cfg, cams[0][0], 2,
                                          device='cpu')):
        st.admit(0)
        st.admit(1)
        st.step({0: cams[0][0], 1: cams[1][0]})
        st.step({0: cams[0][1], 1: cams[1][1]})
        arrays, meta = st.state_dict()
        want = st.step({0: cams[0][2], 1: cams[1][2]})
        st.reset()
        st.load_state(arrays, meta)
        again, meta2 = st.state_dict()
        assert meta2 == meta
        _assert_trees_equal(again, arrays)
        got = st.step({0: cams[0][2], 1: cams[1][2]})
        for s in want:
            assert torch.equal(got[s][0], want[s][0])


def _copy_placement(jmgr, tmgr, port_by_sid):
    """The JAX manager's session placement on the port's manager (what
    ``restore_serving`` restores from a checkpoint's meta)."""
    def same(s):
        t = port_by_sid[s.sid]
        t.cursor = s.cursor
        t.telemetry.admitted_tick = s.telemetry.admitted_tick
        return t
    tmgr.tick = jmgr.tick
    tmgr.slot_session = [None if s is None else same(s)
                         for s in jmgr.slot_session]
    tmgr._coresidents = {k: [same(s) for s in v]
                         for k, v in jmgr._coresidents.items()}
    tmgr.pending = deque(same(s) for s in jmgr.pending)
    tmgr.finished = [same(s) for s in jmgr.finished]
    tmgr.stepper.sort_log = list(jmgr.stepper.sort_log)   # history, not state


def test_jax_state_carried_across_continues_as_jax(scene, monkeypatch):
    fix_jax_unstash(monkeypatch)
    jscene, tscene = scene
    tr = trajs(4, 6)
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=256, window=3), tr[0][0], 2,
        viewers_per_scene=2)
    jmgr = jsession.SessionManager(jst, 2, oversubscribe=True)
    for s in sessions(jsession.ViewerSession, tr, pace=2):
        jmgr.submit(s)
    for _ in range(5):
        sync_tick(jmgr)
    assert jst._stash and jst.pool_cap > 1
    jarrays, jmeta = jst.state_dict()
    host = jax.tree.map(np.asarray, jarrays)
    arrays, meta = interop.serving_state_from_numpy(host, jmeta,
                                                    device='cpu')

    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=256, window=3), to_cam(tr[0][0]),
        2, viewers_per_scene=2, device='cpu')
    tst.load_state(arrays, meta)
    _, tmeta = tst.state_dict()
    assert tmeta == jmeta, 'meta differs from the JAX package'
    # the arrays, by meaning
    tarr, _ = tst.state_dict()
    for f in ('tags', 'values', 'age', 'clock'):
        np.testing.assert_array_equal(_np(tarr['cache'][f]),
                                      getattr(host['shared'].cache, f))
    for ci, row in enumerate(tarr['pool']):
        for pi, entry in enumerate(row):
            np.testing.assert_array_equal(
                _np(entry['indices']),
                host['shared'].pool.lists.indices[ci, pi])
            np.testing.assert_array_equal(
                _np(entry['proj']['mean2d']),
                host['shared'].pool.proj.mean2d[ci, pi])
    np.testing.assert_array_equal(tarr['priv']['frame_idx'],
                                  host['priv'].frame_idx)
    np.testing.assert_array_equal(_np(tarr['slot_cams']['position']),
                                  host['slot_cams'].position)
    for k, ctx in tarr['stash'].items():
        np.testing.assert_array_equal(_np(ctx['priv']['prev_cam']['quat'][0]),
                                      host['stash'][k]['priv'].prev_cam.quat)

    tmgr = tsession.SessionManager(tst, 2, oversubscribe=True)
    port = {s.sid: s for s in port_sessions(tsession.ViewerSession, tr,
                                            pace=2)}
    _copy_placement(jmgr, tmgr, port)
    assert_state_matches(jst, tst, 'carried across')
    drive_pair(jmgr, tmgr)
    assert sorted(s.sid for s in tmgr.finished) == [0, 1, 2, 3]


def test_cli_checkpoint_restore_and_faults(tmp_path):
    kw = dict(width=32, gaussians=300, capacity=64, device='cpu',
              print_fn=lambda *a, **k: None)
    d = str(tmp_path / 'ck')
    full = trender.serve(2, 6, checkpoint_dir=d, checkpoint_every=4, **kw)
    assert CheckpointManager(d).all_steps() == [4, 8]
    lines = []
    again = trender.serve(2, 6, checkpoint_dir=d, restore=True,
                          **dict(kw, print_fn=lines.append))
    assert any('restored serving state from tick 8' in ln for ln in lines)
    assert again['ticks'] == full['ticks']
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        out = trender.serve(3, 4, faults='all', fault_rate=0.3,
                            fault_seed=1, max_pending=2, **kw)
    assert out['faults_injected'] > 0 and out['shed'] == 1
    with pytest.raises(SystemExit):
        trender.serve(2, 2, oversubscribe=True, viewers_per_scene=2, **kw)
    with pytest.raises(SystemExit):
        trender.serve(2, 2, oversubscribe=True, pace=2, **kw)
