"""The port's ``BatchedStepper`` against the JAX package's on a shared
scene, on the CPU, on both backends: two scenes of two viewers arriving
one tick apart, so lane compaction, idle-scene compaction and the full
batch with an idle lane all occur, one scene's viewers share sorts, and the
other's bucketed pool grows to two entries and shrinks back.  Helpers in
``torch_stepper_parity.py``.
"""
import pytest

from torch_stepper_parity import make_scene, run_batched_parity


@pytest.fixture(scope='module')
def scene():
    return make_scene()


@pytest.mark.parametrize('backends', [('reference', 'reference'),
                                      ('pallas', 'kernel')])
def test_shared_scene_stepper_matches_jax(scene, backends):
    run_batched_parity(scene, 'shared', backends)
