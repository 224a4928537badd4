"""The port's sharded Lumina frame (``core.render_dist._serve_frame``) and
elastic recovery (``runtime.elastic``) on a 4-rank gloo group.

The frame: 1,000 Gaussians of the JAX package's ``structured_scene`` at
64 x 64 px, on (data 2, model 2): each rank projects half the Gaussians
and rasterizes a quarter of the 16 tiles.  Its significance counts equal
the JAX package's mesh frame (run on 4 forced host devices in a process
of its own) exactly and its colors within 128 ulps of magnitude, and on
every rank it equals the port's frame without a mesh bit for bit.
``build_dryrun_cell``'s model FLOPs equal the JAX package's.

Elastic recovery follows ``tests/test_fault_tolerance.py``: a state
checkpointed by rank 0, two ranks lost, ``plan_remesh`` keeping
``model=2``, the new mesh built on every rank and the state restored and
placed on it with ``reshard_tree``: each value comes back exactly.  On
the whole world first, ``ShardCtx``'s layout hook redistributes a
DTensor, and the serving mesh is 1-D.  Last, the train CLI's ``--mesh``
trains the EP MoE under torchrun.
"""
import numpy as np
import pytest
import torch

import jax_mesh_oracle as oracle
import torch_mesh_ranks as ranks
from repro.configs.lumina_3dgs import CONFIG as JCONFIG
from repro.core import render_dist as jrd
from repro.launch.mesh import make_test_mesh as jax_test_mesh

from repro_torch.configs.lumina_3dgs import CONFIG
from repro_torch.core import render_dist as trd
from repro_torch.runtime.sharding import P

ULPS = 128


@pytest.fixture(scope='module')
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'frame.npz'
    oracle.run(path, 'frame')
    return str(path), ranks.load(path)


@pytest.fixture(scope='module')
def frames(jax_out, tmp_path_factory):
    return ranks.spawn(ranks.frame_rank, tmp_path_factory.mktemp('frame'),
                       jax_out[0])


def test_sharded_frame_integers_equal_jax(jax_out, frames):
    want = jax_out[1]['frame/nsig']
    assert want.shape == (16, 256) and want.sum() > 0
    for out in frames:
        np.testing.assert_array_equal(out['mesh'][1].numpy(), want)


def test_sharded_frame_colors_within_128_ulps_of_jax(jax_out, frames):
    want = jax_out[1]['frame/colors']
    eps = np.finfo(np.float32).eps
    for out in frames:
        got = out['mesh'][0].numpy()
        scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0)
        assert (np.abs(got - want) <= ULPS * eps * scale).all()


def test_sharded_frame_equals_the_mesh_free_frame(frames):
    for out in frames:
        for a, b in zip(out['mesh'], out['alone']):
            assert torch.equal(a, b)
        assert torch.equal(out['mesh'][0], frames[0]['mesh'][0])


@pytest.mark.parametrize('shape', sorted(trd.RENDER_SHAPE_TABLE))
def test_dryrun_cell_flops_and_meta_scene(shape):
    assert trd.RENDER_SHAPE_TABLE == jrd.RENDER_SHAPE_TABLE
    jmesh = jax_test_mesh((1, 1))
    _, (jscene,), jflops = jrd.build_dryrun_cell(JCONFIG, jmesh, shape)
    step, (scene,), flops = trd.build_dryrun_cell(CONFIG, None, shape)
    assert callable(step) and flops == jflops
    for f in ('means', 'log_scales', 'quats', 'opacity_logit', 'sh_dc',
              'sh_rest'):
        got = getattr(scene, f)
        assert got.device.type == 'meta'
        assert tuple(got.shape) == getattr(jscene, f).shape
    rule, jrule = trd.scene_specs(None, 1), jrd.scene_specs(jmesh, 1)
    assert rule(scene.means) == P()
    assert tuple(jrule(jscene.means)) == ()


@pytest.fixture(scope='module')
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('elastic')
    return ranks.spawn(ranks.elastic_rank, tmp, str(tmp / 'ck'))


def test_elastic_recovery_reshards_the_restored_state(elastic):
    outs = elastic
    state = {'w': torch.arange(16.0).reshape(4, 4), 'b': torch.arange(6.0),
             'step': torch.tensor(5)}
    for rank, out in enumerate(outs):
        assert out['plan'] == ((1, 2), 2, 2) and out['step'] == 5
        assert out['in_mesh'] == (rank < 2)
        if not out['in_mesh']:
            continue
        for k, v in state.items():
            assert torch.equal(out['full'][k], v), k
        # (data 1, model 2): w's columns and b split over model
        assert torch.equal(out['local']['w'], state['w'][:, 2 * rank:
                                                         2 * rank + 2])
        assert torch.equal(out['local']['b'], state['b'][3 * rank:
                                                         3 * rank + 3])


def test_layout_hooks_redistribute_a_dtensor(elastic):
    """``ShardCtx.btd`` on (data 2, model 2) places [4, 8, 3] batch over
    data and sequence over model, as JAX's ``with_sharding_constraint``
    would; the serving mesh is 1-D over every rank."""
    from torch.distributed.tensor import Shard
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    for rank, out in enumerate(elastic):
        assert out['serve_axes'] == ('devices',)
        assert out['fleet'] == [str(Shard(0))]
        assert out['btd'] == [str(Shard(0)), str(Shard(1))]
        d, m = divmod(rank, 2)
        assert torch.equal(out['btd_local'], x[2 * d:2 * d + 2,
                                               4 * m:4 * m + 4])
        assert torch.equal(out['btd_full'], x)



def test_train_cli_runs_on_a_torchrun_mesh():
    """``launch.train --mesh`` under torchrun: 2 gloo ranks on (data 1,
    model 2), the MoE FFN expert-parallel; rank 0 alone prints."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.path.join(root, 'src'))
    out = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', '2', '-m', 'repro_torch.launch.train',
         '--device', 'cpu', '--mesh', '1,2', '--arch',
         'granite-moe-1b-a400m', '--steps', '2', '--batch', '2', '--seq',
         '16'], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count('final loss') == 1
    assert out.stdout.count('step     0  loss') == 1
