"""Shared helpers of the stepper parity tests (``test_torch_stepper*.py``):
the JAX package's ``BatchedStepper`` and the port's replay one seeded
schedule of admissions, releases and cameras; the ``sort_log``, sorted
flags, hit rates, ``saved_frac`` and cache tags/age/clock must be equal and
images within 128 ulps x magnitude.  The parity tests are split over two
files so that parallel test workers run them side by side."""
import jax
import numpy as np
import torch

from repro.core import pipeline as jpipe
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import stepper as jstepper

from repro_torch import interop
from repro_torch.core import pipeline as tpipe
from repro_torch.serve import stepper as tstepper

SEED, WIDTH = 7, 64


def assert_images_ulp_close(got, want, *, ulps=128, err_msg=''):
    """Float comparison with an ulp-scaled float32 tolerance: ``ulps`` x
    float32-eps x magnitude (floored at 1.0).  Copied from
    tests/test_serve.py."""
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


def make_scene(n=800):
    """``structured_scene(PRNGKey(7), n)`` on both sides."""
    jscene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), n)
    return jscene, interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                            device='cpu')


def staggered_schedule(viewers, frames, stagger, start_deg):
    """``(releases, admits, jax cams)`` per tick: viewer i takes slot i at
    tick ``i * stagger`` and renders ``frames`` frames of its orbit; its
    slot is released on the tick after its last frame (as the session
    manager evicts it)."""
    trajs = [jax_orbit(frames, width=WIDTH, height_px=WIDTH,
                       start_deg=start_deg(i)) for i in range(viewers)]
    ticks = []
    for t in range((viewers - 1) * stagger + frames + 1):
        releases = [i for i in range(viewers) if t == i * stagger + frames]
        admits = [i for i in range(viewers) if t == i * stagger]
        cams = {i: trajs[i][t - i * stagger] for i in range(viewers)
                if 0 <= t - i * stagger < frames}
        ticks.append((releases, admits, cams))
    return ticks


def drive(stepper, schedule, convert):
    outs = []
    for releases, admits, cams in schedule:
        for i in releases:
            stepper.release(i)
        for i in admits:
            stepper.admit(i)
        if cams:
            outs.append(stepper.step({i: convert(c) for i, c in cams.items()}))
    return outs


def assert_runs_match(jst, tst, jouts, touts):
    assert tst.sort_log == jst.sort_log
    assert len(touts) == len(jouts)
    for tick, (jo, to) in enumerate(zip(jouts, touts)):
        assert sorted(to) == sorted(jo)
        for slot in jo:
            img_j, st_j, _ = jo[slot]
            img_t, st_t, _ = to[slot]
            msg = f'tick {tick} slot {slot}'
            assert float(st_t.sorted_this_frame) == \
                float(st_j.sorted_this_frame), msg
            assert float(st_t.hit_rate) == float(st_j.hit_rate), msg
            assert float(st_t.saved_frac) == float(st_j.saved_frac), msg
            assert_images_ulp_close(_np(img_t), img_j, err_msg=msg)
    jc, tc = jst.shared.cache, tst.shared.cache
    for field in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(tc, field)),
                                      np.asarray(getattr(jc, field)), field)


SETUPS = {
    # three slots, all admitted at tick 0, window 2
    'cohort': dict(viewers=3, frames=5, stagger=0, window=2, vps=1,
                   start_deg=lambda i: 120.0 * i),
    # two scenes of two viewers arriving one tick apart.  Scene 0's second
    # viewer starts one frame (25/90 deg) further round, so the pair render
    # one pose cell on each tick and share its sorts; scene 1's viewers sit
    # 90 deg apart, so its pool grows to two entries and shrinks back
    'shared': dict(viewers=4, frames=3, stagger=1, window=3, vps=2,
                   start_deg=lambda i: (0.0, 25.0 / 90.0, 180.0, 270.0)[i]),
}


def run_batched_parity(scene, setup, backends):
    """Replay ``SETUPS[setup]`` through both packages' ``BatchedStepper``."""
    jscene, tscene = scene
    p = SETUPS[setup]
    schedule = staggered_schedule(p['viewers'], p['frames'], p['stagger'],
                                  p['start_deg'])
    cam0 = schedule[0][2][0]
    jcfg = jpipe.LuminaConfig(capacity=128, window=p['window'],
                              backend=backends[0])
    tcfg = tpipe.LuminaConfig(capacity=128, window=p['window'],
                              backend=backends[1])
    jst = jstepper.BatchedStepper(jscene, jcfg, cam0, slots=p['viewers'],
                                  viewers_per_scene=p['vps'])
    tst = tstepper.BatchedStepper(tscene, tcfg, to_cam(cam0),
                                  slots=p['viewers'],
                                  viewers_per_scene=p['vps'], device='cpu')
    jouts = drive(jst, schedule, lambda c: c)
    touts = drive(tst, schedule, to_cam)
    assert_runs_match(jst, tst, jouts, touts)
    flags = [float(o[s][1].sorted_this_frame) for o in touts for s in o]
    assert 0 < sum(flags) < len(flags)
    if setup == 'shared':
        assert sum(e['joined'] for e in tst.sort_log) > 0
        assert tst.metrics['pool.resizes'].value >= 2
        assert tst.state_metrics()['sort_pool_live'] >= 1
    # a reset stepper replays the schedule from a cold start
    log = list(tst.sort_log)
    tst.reset()
    again = drive(tst, schedule, to_cam)
    assert tst.sort_log == log
    for a, b in zip(again, touts):
        assert {s: float(o[1].hit_rate) for s, o in a.items()} == \
            {s: float(o[1].hit_rate) for s, o in b.items()}
