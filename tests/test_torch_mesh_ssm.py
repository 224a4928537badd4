"""The port's partitioned recurrent programs (recipe ``ssm``) against the
JAX package's, on 4 gloo ranks and 4 forced host devices (the oracle runs
in a process of its own).

Reduced xlstm-1.3b (two super-blocks of an mLSTM and an sLSTM block, 3
heads of hd 64, remat on) and reduced zamba2-1.2b (4 Mamba2 layers, two
attention points) on (data 2, model 2).  3 heads do not divide ``model``,
so the mLSTM state takes the production layout, dk over ``model``
(xlstm-1.3b's 4 heads on 16 ranks); zamba2's ``w_in`` output and conv
channels straddle the ranks, as at production size.  Both packages start
from JAX's weights (``interop.lm_params_on_mesh``) and the same seeded
batches, laid out by ``param_specs`` (the ``tp`` table), ``batch_
shardings`` and ``decode_state_specs``, the Adam state as its parameters:
JAX's programs jitted with those ``in_shardings`` and ``out_shardings``,
the port's registry steps on the DTensor layout.

Checked: three train losses within 1e-5 of JAX's, the gradient norms of
the two steps that no update precedes within 1e-5 (lr 3e-3 with one
warmup step, as ``tests/test_torch_mesh_tp.py``); the prefill's logits
within 1e-5 beyond the reference's own partitioning noise, the distance
between JAX's partitioned and unpartitioned prefills (zamba2's attention
rounds q and k to bfloat16, which turns the split sums' float32 ulps into
~1e-5: 1.04e-5 between JAX's two programs, 1.27e-5 between the port's);
the decode logits at positions 0..11 within 1e-5 and
every state leaf within 1e-5 + 1e-5 relative of JAX's partitioned decode,
every leaf a DTensor; every parameter's, moment's and state leaf's local
block exactly JAX's ``shard_shape``; zamba2's cache writes landing only
in the blocks that hold ``pos``, in the state given; the trained state
identical on every rank; the partitioned first loss within 1e-5 of the
port's unpartitioned one.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax_ssm_oracle as oracle
import torch_mesh_ranks as ranks
import torch_ssm_ranks as ssm_ranks

TOL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = tuple(oracle.ARCHS)


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'ssm.npz'
    oracle.run(path, *ARCHS)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    """Each rank's records by arch: a 4-rank group an arch, side by side."""
    tmp = tmp_path_factory.mktemp('ssm')
    with concurrent.futures.ThreadPoolExecutor(len(ARCHS)) as pool:
        groups = list(pool.map(lambda arch: ranks.spawn(
            ssm_ranks.ssm_rank, tmp, npz, (arch,)), ARCHS))
    return [{k: v for group in groups for k, v in group[r].items()}
            for r in range(ranks.WORLD)]


def _jax_key(name: str) -> tuple:
    """A port parameter name as the JAX leaf key and its count of stacked
    layer axes (``blocks.1.mlstm.0.wq`` -> (``blocks/mlstm/wq``, 2))."""
    parts = name.split('.')
    return ('/'.join(p for p in parts if not p.isdigit()),
            sum(p.isdigit() for p in parts))


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
    ref = want[f'{arch}/logits']
    noise = float(np.abs(ref - want[f'{arch}/plain_logits']).max())
    for run in runs:
        got = run[arch]
        assert set(got['logits_placements']) == {'R'}
        np.testing.assert_allclose(got['logits'].numpy(), ref,
                                   atol=TOL + noise, rtol=0)


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_decode_matches_jax(arch, want, runs):
    for run in runs:
        got = run[arch]
        assert set(got['decode_placements']) == {'R'}
        assert got['state_dtensor'] and got['same_state']
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   want[f'{arch}/decode_logits'], atol=TOL,
                                   rtol=0)
        assert torch.equal(got['decode_logits'],
                           runs[0][arch]['decode_logits'])
        assert set(got['state']) == {k[len(f'{arch}/state/'):]
                                     for k in want
                                     if k.startswith(f'{arch}/state/')}
        for key, leaf in got['state'].items():
            np.testing.assert_allclose(
                leaf.float().numpy(),
                want[f'{arch}/state/{key}'].astype(np.float32), **STATE_TOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_local_blocks_are_jax_shard_shapes(arch, want, runs):
    for run in runs:
        got = run[arch]
        names = list(got['local'])
        assert len(got['moment_local']) == len(names)
        for name, (mu, nu) in zip(names, got['moment_local']):
            key, stacked = _jax_key(name)
            shard = tuple(int(n) for n in want[f'{arch}/shard/{key}'])
            assert got['local'][name] == shard[stacked:], name
            assert mu == nu == shard[stacked:], name
        assert got['step'] == (oracle.STEPS, ['R', 'R'])
        for key, shape in got['state_local'].items():
            shard = tuple(int(n) for n in want[f'{arch}/state_shard/{key}'])
            assert shape == shard, key


def test_state_layouts_split_the_production_dims(runs):
    """xlstm's mLSTM state [ns, 1, B, 3, 64, 65]: batch over ``data``, dk
    over ``model`` (3 heads do not divide it); the sLSTM's h and c: batch
    and di.  zamba2's SSD state: batch and heads; its conv window: batch
    and channels; its caches: batch and sequence."""
    for run in runs:
        x, z = run['xlstm-1.3b'], run['zamba2-1.2b']
        assert x['state_placements'] == {
            'mlstm': ['S(2)', 'S(4)'], 'slstm_h': ['S(1)', 'S(2)'],
            'slstm_c': ['S(1)', 'S(2)']}
        assert x['state_local']['mlstm'] == (2, 1, 2, 3, 32, 65)
        assert z['state_placements'] == {
            'ssm/ssm': ['S(1)', 'S(2)'], 'ssm/conv': ['S(1)', 'S(3)'],
            'kv_k': ['S(1)', 'S(2)'], 'kv_v': ['S(1)', 'S(2)']}


def test_cache_writes_land_only_in_the_block_that_holds_pos(runs):
    ranges = set()
    for run in runs:
        got = run['zamba2-1.2b']
        start, stop = got['seq_range']
        ranges.add((start, stop))
        for pos, changed in zip(oracle.POSITIONS, got['changed']):
            assert changed == [start <= pos < stop] * 2, (pos, start, stop)
    assert ranges == {(0, 8), (8, 16)}


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
        key, stacked = _jax_key(name)
        assert p.shape == want[f'{arch}/params/{key}'].shape[stacked:]


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_loss_matches_the_unpartitioned_port(arch, runs):
    for run in runs:
        got = run[arch]
        assert abs(got['loss'][0] - got['plain_loss']) <= TOL
