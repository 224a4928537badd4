"""The port's partitioned LM program against the JAX package's, on 4 gloo
ranks and 4 forced host devices (the oracle runs in a process of its own).

Reduced smollm-360m (recipe ``dp``: parameters replicated, batch over
``data``, activations by the ``ShardCtx`` hooks) and reduced yi-34b
(recipe ``tp``: FSDP over ``data``, TP over ``model``; remat on) on (data
2, model 2).  Both packages start from JAX's weights (``interop.
lm_params_on_mesh``) and the same seeded batches, laid out by
``param_specs`` and ``batch_shardings`` with the Adam state as its
parameters: JAX's step jitted with those ``in_shardings`` and
``out_shardings``, the port's ``registry.make_train_step`` on the
DTensor layout.  Three steps at lr 3e-3 with one warmup step: the
schedule's scale is 0 at step 0, so the third loss is the first that an
update (step 1's) moves.  Checked: every loss within 1e-5 of JAX's, the
gradient norms of the two steps that no update precedes within 1e-5, the
prefill's logits within 1e-5 absolute, every parameter's and moment's
local block exactly JAX's ``shard_shape`` (less the stacked layer axis),
the trained parameters and moments gathered identical on every rank, the
metrics replicated, and the partitioned first loss within 1e-5 of the
same weights' unpartitioned loss.

The third gradient norm and the trained weights are not held to JAX's:
Adam's first update divides each moment by its own root, so a gradient
entry near zero moves its weight by up to ``lr`` whatever its size, and
float32 noise in such entries moves some weights by 2e-3.  The port's
unpartitioned step shows the same on these batches (third norm 1.2e-5
from JAX's, embedding weights up to 2.0e-3), so it is not the layout's.
"""
import numpy as np
import pytest
import torch

import jax_tp_oracle as oracle
import torch_mesh_ranks as ranks
import torch_tp_ranks as tp_ranks

TOL = 1e-5
ARCHS = tuple(oracle.ARCHS)


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'tp.npz'
    oracle.run(path, *ARCHS)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    return ranks.spawn(tp_ranks.tp_rank, tmp_path_factory.mktemp('tp'), npz,
                       ARCHS)


def _jax_key(name: str) -> tuple:
    """A port parameter name as the JAX leaf key and its layer index
    (``blocks.1.attn.wq`` -> (``blocks/attn/wq``, 1))."""
    parts = name.split('.')
    layer = next((int(p) for p in parts if p.isdigit()), None)
    return '/'.join(p for p in parts if not p.isdigit()), layer


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_losses_match_jax(arch, want, runs):
    for run in runs:
        got = run[arch]
        np.testing.assert_allclose(got['loss'], want[f'{arch}/loss'],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got['grad_norm'][:2],
                                   want[f'{arch}/grad_norm'][:2],
                                   atol=TOL, rtol=0)
        assert got['loss'] == runs[0][arch]['loss']
        for pl in got['metric_placements']:
            assert set(pl) == {'R'}, pl


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_prefill_matches_jax(arch, want, runs):
    for run in runs:
        got = run[arch]
        assert set(got['logits_placements']) == {'R'}
        np.testing.assert_allclose(got['logits'].numpy(),
                                   want[f'{arch}/logits'], atol=TOL, rtol=0)


@pytest.mark.parametrize('arch', ARCHS)
def test_local_blocks_are_jax_shard_shapes(arch, want, runs):
    for run in runs:
        got = run[arch]
        names = list(got['local'])
        assert len(got['moment_local']) == len(names)
        for name, (mu, nu) in zip(names, got['moment_local']):
            key, layer = _jax_key(name)
            shard = tuple(int(n) for n in want[f'{arch}/shard/{key}'])
            if layer is not None:     # JAX's stacked layer axis
                shard = shard[1:]
            assert got['local'][name] == shard, name
            assert mu == nu == shard, name
        assert got['step'] == (oracle.STEPS, ['R', 'R'])


@pytest.mark.parametrize('arch', ARCHS)
def test_trained_state_is_identical_on_every_rank(arch, want, runs):
    first = runs[0][arch]
    for run in runs[1:]:
        got = run[arch]
        assert list(got['params']) == list(first['params'])
        for name, p in got['params'].items():
            assert torch.equal(p, first['params'][name]), name
        for tree in ('mu', 'nu'):
            for a, b in zip(got[tree], first[tree]):
                assert torch.equal(a, b), tree
    for name, p in first['params'].items():    # every leaf of JAX's tree
        key, layer = _jax_key(name)
        ref = want[f'{arch}/params/{key}']
        assert p.shape == (ref.shape if layer is None else ref.shape[1:])


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_loss_matches_the_unpartitioned_port(arch, runs):
    for run in runs:
        got = run[arch]
        assert abs(got['loss'][0] - got['plain_loss']) <= TOL
