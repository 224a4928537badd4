"""The port's train driver and token server on a device mesh against the
JAX package's on 4 forced host devices (run in a process of its own).

``launch.train.train`` of reduced granite-moe (the expert-parallel MoE
FFN, whose gradients must be right for the second update to match) and
reduced smollm (recipe ``dp``: the mesh pads heads to its ``model`` size,
2) on (data 2, model 2), each from the JAX run's starting weights through
``interop``, every rank the same program on a 4-rank gloo group.  Three
steps at lr 3e-3 with one warmup step: the schedule's scale is 0 at step
0, so the third loss is the first that an update (step 1's) moves.  Every
loss within 1e-5 of JAX's, every rank's losses and weights identical.
Granite's token server on the same mesh decodes through the local MoE
path (a one-token step is not divisible by ``model``), token for token as
JAX's.
"""
import numpy as np
import pytest
import torch

import jax_mesh_oracle as oracle
import torch_mesh_ranks as ranks

LOSS_TOL = 1e-5


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'train.npz'
    oracle.run(path, 'train')
    return str(path)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    return ranks.spawn(ranks.train_rank, tmp_path_factory.mktemp('train'),
                       npz)


@pytest.mark.parametrize('arch', oracle.TRAIN_ARCHS)
def test_mesh_training_matches_jax(arch, npz, runs):
    want = ranks.load(npz)[f'train/{arch}/loss']
    outs = [r[arch] for r in runs]
    losses = np.asarray(outs[0]['loss'])
    assert losses.shape == (oracle.TRAIN['steps'],)
    np.testing.assert_allclose(losses, want, atol=LOSS_TOL, rtol=0)
    for out in outs[1:]:
        assert out['loss'] == outs[0]['loss']
        for k, p in out['params'].items():
            assert torch.equal(p, outs[0]['params'][k]), k


def test_mesh_server_decodes_locally_as_jax(npz, runs):
    want = ranks.load(npz)
    for run in runs:
        srv = run['serve']
        assert srv['tp'] == 2 and srv['ep_calls'] == 0
        assert srv['tokens'] == {i: want[f'serve/{i}'].tolist()
                                 for i in range(oracle.SERVE_REQUESTS)}
