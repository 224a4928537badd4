"""The port's steppers against the JAX package's, on the CPU, on both
backends: ``BatchedStepper`` over three slots with window 2 (the cohort
alternates between a full and a padded gather), and ``SequentialStepper``
with one viewer.  The shared-scene setup is in
``test_torch_stepper_shared.py``; the helpers in ``torch_stepper_parity.py``.
"""
import numpy as np
import pytest

from repro.core import pipeline as jpipe
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.serve import stepper as jstepper

from repro_torch.core import pipeline as tpipe
from repro_torch.serve import stepper as tstepper
from torch_stepper_parity import (WIDTH, _np, assert_images_ulp_close, drive,
                                  make_scene, run_batched_parity, to_cam)


@pytest.fixture(scope='module')
def scene():
    return make_scene()


@pytest.mark.parametrize('backends', [('reference', 'reference'),
                                      ('pallas', 'kernel')])
def test_batched_stepper_matches_jax(scene, backends):
    run_batched_parity(scene, 'cohort', backends)


@pytest.mark.parametrize('backends', [('reference', 'reference'),
                                      ('pallas', 'kernel')])
def test_sequential_stepper_matches_jax(scene, backends):
    jscene, tscene = scene
    traj = jax_orbit(5, width=WIDTH, height_px=WIDTH)
    jcfg = jpipe.LuminaConfig(capacity=128, window=2, backend=backends[0])
    tcfg = tpipe.LuminaConfig(capacity=128, window=2, backend=backends[1])
    jst = jstepper.SequentialStepper(jscene, jcfg, traj[0], slots=1)
    tst = tstepper.SequentialStepper(tscene, tcfg, to_cam(traj[0]), slots=1,
                                     device='cpu')
    schedule = [([], [0] if f == 0 else [], {0: cam})
                for f, cam in enumerate(traj)]
    jouts = drive(jst, schedule, lambda c: c)
    touts = drive(tst, schedule, to_cam)
    assert tst.sort_log == jst.sort_log
    for f, (jo, to) in enumerate(zip(jouts, touts)):
        assert float(to[0][1].hit_rate) == float(jo[0][1].hit_rate)
        assert float(to[0][1].sorted_this_frame) == \
            float(jo[0][1].sorted_this_frame)
        assert_images_ulp_close(_np(to[0][0]), jo[0][0], err_msg=f'frame {f}')
    jc, tc = jst._states[0].cache, tst._states[0].cache
    for field in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(tc, field)),
                                      np.asarray(getattr(jc, field)), field)
    assert tst.state_metrics()['state_alloc_bytes'] > 0


