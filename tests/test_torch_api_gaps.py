"""Four names of ported modules held against the JAX package's, on the
CPU: ``core.sorting.pairwise_order_agreement`` (the paper's S^2 order
agreement, Sec. 3.1), ``core.camera.world_to_camera``,
``serve.session.ViewerSession.current_cam`` and
``SessionManager.admit_ready`` (the admission call of the pre-pipeline
serving loop).

Tolerances: the order agreement equals JAX's to float32 rounding (one
division of equal integer counts, so exactly); ``world_to_camera`` within
1e-6 absolute + 1e-6 relative (float32 products summed in another order);
admissions exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import camera as jcamera
from repro.core import pipeline as jpipe
from repro.core import projection as jproj
from repro.core import sorting as jsorting
from repro.core.tiling import TileLists as JTileLists
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch import interop
from repro_torch.core import camera as tcamera
from repro_torch.core import pipeline as tpipe
from repro_torch.core import projection as tproj
from repro_torch.core import sorting as tsorting
from repro_torch.core.tiling import TileLists
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from torch_serve_parity import one_torch_thread  # noqa: F401
from torch_stepper_parity import to_cam

CAPACITY, WIDTH = 256, 64
jax_agreement = jax.jit(jsorting.pairwise_order_agreement)


@pytest.fixture(scope='module')
def fixture_lists(small_scene, cams64):
    """``tests/test_core_render.py::test_order_agreement_high_for_nearby_
    poses``' setting: frames 0-2 of the 64-px orbit sorted at capacity 256,
    in both packages (the lists are equal)."""
    sort = jax.jit(lambda c: jsorting.sort_scene(
        jproj.project(small_scene, c), WIDTH, WIDTH, CAPACITY))
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in small_scene],
                                      device='cpu')
    out = []
    for cam in cams64[:3]:
        jl = sort(cam)
        tl = tsorting.sort_scene(tproj.project(tscene, to_cam(cam)), WIDTH,
                                 WIDTH, CAPACITY)
        np.testing.assert_array_equal(tl.indices.numpy(),
                                      np.asarray(jl.indices))
        out.append((jl, tl))
    return out


@pytest.mark.parametrize('a,b', [(0, 1), (1, 2), (0, 2), (1, 1)])
def test_order_agreement_on_the_fixture(fixture_lists, a, b):
    (ja, ta), (jb, tb) = fixture_lists[a], fixture_lists[b]
    want = np.asarray(jax_agreement(ja, jb))
    got = tsorting.pairwise_order_agreement(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want)
    if a == b:
        assert float(got) == 1.0
    elif b == a + 1:        # adjacent poses, as the JAX test asserts
        assert float(got) > 0.9


@pytest.mark.parametrize('seed', range(4))
def test_order_agreement_on_ragged_lists(seed):
    """Rows with -1 padding, ids missing from the other sort, duplicate
    ids (the first position counts) and empty tiles."""
    rng = np.random.default_rng(seed)
    t, k = 9, 24
    a = rng.integers(0, 40, size=(t, k)).astype(np.int32)
    b = np.stack([rng.permutation(a[i]) for i in range(t)])
    b[:, ::3] = rng.integers(0, 60, size=b[:, ::3].shape)
    for rows, cut in ((a, 17), (b, 11)):
        rows[1, cut:] = -1
    a[2] = -1
    b[3] = -1
    b[4, :] = a[4, ::-1]
    want = float(np.asarray(jax_agreement(
        JTileLists(jax.numpy.asarray(a), None, 3, 3),
        JTileLists(jax.numpy.asarray(b), None, 3, 3))))
    got = tsorting.pairwise_order_agreement(
        TileLists(torch.from_numpy(a), None, 3, 3),
        TileLists(torch.from_numpy(b), None, 3, 3))
    assert float(got) == want
    empty = TileLists(torch.full((2, 5), -1, dtype=torch.int32), None, 1, 2)
    assert float(tsorting.pairwise_order_agreement(empty, empty)) == 0.0


def test_world_to_camera(cams64):
    pts = np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32) * 3
    for cam in cams64:
        want = np.asarray(jcamera.world_to_camera(cam, jax.numpy.asarray(pts)))
        got = tcamera.world_to_camera(to_cam(cam), torch.from_numpy(pts))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def _sessions(module, cams, scene_ids, arrivals):
    return [module.ViewerSession(sid=i, cams=list(cams), scene_id=s,
                                 arrival_tick=t)
            for i, (s, t) in enumerate(zip(scene_ids, arrivals))]


def _placed(mgr):
    return {i: s.sid for i, s in enumerate(mgr.slot_session) if s is not None}


@pytest.fixture(scope='module')
def steppers(small_scene):
    """Factories of each package's ``BatchedStepper`` over one scene."""
    jcams = jax_orbit(4, width=WIDTH, height_px=WIDTH)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in small_scene],
                                      device='cpu')
    tcams = [to_cam(c) for c in jcams]

    def make(vps):
        js = jstepper.BatchedStepper(
            small_scene, jpipe.LuminaConfig(capacity=CAPACITY, window=3),
            jcams[0], slots=4, viewers_per_scene=vps)
        ts = tstepper.BatchedStepper(
            tscene, tpipe.LuminaConfig(capacity=CAPACITY, window=3),
            tcams[0], slots=4, viewers_per_scene=vps, device='cpu')
        return js, ts
    return make, jcams, tcams


def test_scene_blocked_admission_matches_jax(steppers):
    """``tests/test_scene_shared.py::test_scene_blocked_admission``'s
    scenario: three sessions for scene 0's two-slot block and one for
    scene 1; sid 2 waits without blocking sid 3."""
    make, jcams, tcams = steppers
    js, ts = make(2)
    jm, tm = jsession.SessionManager(js, 4), tsession.SessionManager(ts, 4)
    for mgr, mod, cams in ((jm, jsession, jcams), (tm, tsession, tcams)):
        for s in _sessions(mod, cams, (0, 0, 0, 1), (0, 0, 0, 0)):
            mgr.submit(s)
    got, want = tm.admit_ready(), jm.admit_ready()
    assert got == want == [0, 1, 2]
    assert _placed(tm) == _placed(jm) == {0: 0, 1: 1, 2: 3}
    assert [s.sid for s in tm.pending] == [s.sid for s in jm.pending] == [2]
    assert ts._resident == js._resident
    # a freed slot of block 0 takes sid 2; block 1 still has room
    for mgr in (jm, tm):
        mgr.slot_session[1] = None
    assert tm.admit_ready() == jm.admit_ready() == [1]
    assert _placed(tm) == _placed(jm) == {0: 0, 1: 2, 2: 3}
    assert not tm.pending and not jm.pending


def test_fifo_admission_and_current_cam_match_jax(steppers):
    """One viewer a scene: FIFO over the free slots, stopping at the first
    session that has not arrived; ``current_cam`` is the cursor's camera."""
    make, jcams, tcams = steppers
    js, ts = make(1)
    jm, tm = jsession.SessionManager(js, 4), tsession.SessionManager(ts, 4)
    arrivals = (0, 0, 2, 0, 1)
    for mgr, mod, cams in ((jm, jsession, jcams), (tm, tsession, tcams)):
        for s in _sessions(mod, cams, (0,) * 5, arrivals):
            mgr.submit(s)
    for tick in (0, 1, 2):
        for mgr in (jm, tm):
            mgr.tick = tick
        assert tm.admit_ready() == jm.admit_ready(), tick
        assert _placed(tm) == _placed(jm), tick
        assert [s.sid for s in tm.pending] == [s.sid for s in jm.pending]
    assert _placed(tm) == {0: 0, 1: 1, 2: 2, 3: 3}
    assert [s.sid for s in tm.pending] == [4]
    sess = tm.slot_session[2]
    sess.cursor = 2
    assert sess.current_cam() is sess.cams[2]
    jsess = jm.slot_session[2]
    jsess.cursor = 2
    np.testing.assert_array_equal(sess.current_cam().position.numpy(),
                                  np.asarray(jsess.current_cam().position))
