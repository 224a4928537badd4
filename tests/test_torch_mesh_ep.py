"""The port's partitioned MoE program (recipe ``ep``) against the JAX
package's, on 4 gloo ranks and 4 forced host devices (the oracle runs in a
process of its own).

Reduced granite-moe-1b-a400m (top-2 of 4 experts, remat on, its
published setting) and reduced llama4-maverick-400b-a17b (top-1, two
super-blocks of a dense layer and an MoE layer, the shared expert,
bfloat16 Adam moments) on (data 2, model 2).  Both packages start from
JAX's weights (``interop.lm_params_on_mesh``) and the same seeded
batches, laid out by ``param_specs`` (the experts over ``model`` and
their rows over ``data``, the dense submodules and the shared expert by
the ``tp`` table), ``batch_shardings`` and ``decode_state_specs``, the
Adam state as its parameters: JAX's programs jitted with those
``in_shardings`` and ``out_shardings``, the port's registry steps on the
DTensor layout.  The train step runs the expert-parallel body on each
rank's blocks (sequence 64 divides ``model``); the decode step's one token
does not, so it takes the local path on the DTensor.

Checked: three train losses within 1e-5 of JAX's, the gradient norms of
the two steps that no update precedes within 1e-5 (lr 3e-3 with one
warmup step, as ``tests/test_torch_mesh_tp.py``), the prefill's logits
within 1e-5; the decode logits at positions 0..11 on a 16-position cache
within 1e-5 and the caches within 1e-5 + 1e-5 relative of JAX's
partitioned decode; every parameter's, moment's and cache's local block
exactly JAX's ``shard_shape``; the write landing only in the blocks that
hold ``pos``, in the state given; the trained state identical on every
rank; the partitioned first loss within 1e-5 of the port's unpartitioned
one; the skewed forward's mean drop fraction exactly JAX's (nonzero: the
per-rank capacity drops the tokens that want expert 0 on the ranks of
data block 0), every MoE layer through the expert-parallel body on its
rank's block of ``x``.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax_ep_oracle as oracle
import torch_ep_ranks as ep_ranks
import torch_mesh_ranks as ranks
from repro_torch.configs import get_config

TOL = 1e-5
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = tuple(oracle.ARCHS)


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'ep.npz'
    oracle.run(path, *ARCHS)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    """Each rank's records by arch: a 4-rank group an arch, side by side."""
    tmp = tmp_path_factory.mktemp('ep')
    with concurrent.futures.ThreadPoolExecutor(len(ARCHS)) as pool:
        groups = list(pool.map(lambda arch: ranks.spawn(
            ep_ranks.ep_rank, tmp, npz, (arch,)), ARCHS))
    return [{k: v for group in groups for k, v in group[r].items()}
            for r in range(ranks.WORLD)]


def _jax_key(name: str) -> tuple:
    """A port parameter name as the JAX leaf key and its layer index
    (``blocks.1.moe.w_up`` -> (``blocks/moe/w_up``, 1))."""
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
def test_partitioned_decode_matches_jax(arch, want, runs):
    for run in runs:
        got = run[arch]
        assert set(got['decode_placements']) == {'R'}
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   want[f'{arch}/decode_logits'], atol=TOL,
                                   rtol=0)
        assert torch.equal(got['decode_logits'],
                           runs[0][arch]['decode_logits'])
        for cache, key in zip(got['caches'], 'kv'):
            np.testing.assert_allclose(cache.numpy(), want[f'{arch}/{key}'],
                                       **CACHE_TOL)


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
        # each rank holds a quarter of every expert weight: experts over
        # model, rows over data
        assert got['local']['blocks.0.moe.w_up'] == (2, 64, 256)
        assert got['local']['blocks.0.moe.w_down'] == (2, 256, 64)
        cache = tuple(int(n) for n in want[f'{arch}/cache_shard'])
        assert got['cache_local'] == [cache, cache]
        assert cache[2:4] == (oracle.DECODE_BATCH // 2, oracle.MAX_SEQ // 2)
        assert got['cache_placements'] == ['S(2)', 'S(3)']


@pytest.mark.parametrize('arch', ARCHS)
def test_write_lands_only_in_the_block_that_holds_pos(arch, runs):
    ranges = set()
    for run in runs:
        got = run[arch]
        assert got['same_state']
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
        key, layer = _jax_key(name)
        ref = want[f'{arch}/params/{key}']
        assert p.shape == (ref.shape if layer is None else ref.shape[1:])


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_loss_matches_the_unpartitioned_port(arch, runs):
    for run in runs:
        got = run[arch]
        assert abs(got['loss'][0] - got['plain_loss']) <= TOL


@pytest.mark.parametrize('arch', ARCHS)
def test_skewed_router_drops_as_jax(arch, want, runs):
    drop = float(want[f'{arch}/skew_drop'])
    assert drop > 0
    cfg = get_config(arch).reduced(**oracle.ARCHS[arch])
    n_moe = cfg.n_layers // cfg.moe_every
    local = (oracle.SKEW_BATCH // 2, oracle.SKEW_SEQ // 2)
    for run in runs:
        got = run[arch]
        assert float(got['skew_drop']) == drop
        assert [c[0] for c in got['ep_calls']] == ['DTensor'] * n_moe
        assert {c[2][:2] for c in got['ep_calls']} == {local}
