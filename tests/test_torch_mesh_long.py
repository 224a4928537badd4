"""The port's long-context decode (the ``long_500k`` layout) against the
JAX package's, on 4 gloo ranks and 4 forced host devices (the oracle
runs in processes of its own).

Reduced zamba2-1.2b (4 Mamba2 layers, two attention points) with 4 kv
heads, which ``model`` (2) divides, and with 3, which it does not, and
reduced xlstm-1.3b (3 heads, dk over ``model``), all at batch 1 on (data
2, model 2).  Both packages start from JAX's weights (``interop.
lm_params_on_mesh``) and a zeroed state laid out by
``decode_state_specs(long_context=True)``: zamba2's caches [pts, 1, T, H,
hd] with the sequence over ``data`` and the heads (4) or head_dim (3
heads) over ``model``; JAX's decode jitted with those ``in_shardings``
under ``make_ctx(long_context=True)``, the port's registry step on the
DTensor layout (``shard_decode_inputs(long_context=True)``).

Checked: the decode logits at positions 0..11 (both blocks of the
sequence) within 1e-5 of JAX's, every state leaf within 1e-5 + 1e-5
relative; every state leaf a DTensor whose local block is JAX's
``shard_shape``; the K/V writes landing only in the ``data`` rank whose
block holds ``pos``, in the state given; the partitioned logits within
1e-5 of the port's unpartitioned decode on the same ranks; ``repeat_kv``
on kv heads split over ``model`` equal to the plain gather, keeping the
heads split where each rank's q heads map into its own kv heads and
gathering them whole where a padded head clamps across the blocks.
"""
import numpy as np
import pytest
import torch

import jax_long_oracle as oracle
import torch_long_ranks as long_ranks
import torch_mesh_ranks as ranks

TOL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
CASES = tuple(oracle.CASES)
ZAMBA = ('zamba2-kv4', 'zamba2-kv3')


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'long.npz'
    oracle.run(path, *CASES)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    return ranks.spawn(long_ranks.long_rank, tmp_path_factory.mktemp('long'),
                       npz, CASES)


@pytest.mark.parametrize('case', CASES)
def test_long_context_decode_matches_jax(case, want, runs):
    for run in runs:
        got = run[case]
        assert set(got['decode_placements']) == {'R'}
        assert got['state_dtensor'] and got['same_state']
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   want[f'{case}/decode_logits'], atol=TOL,
                                   rtol=0)
        assert torch.equal(got['decode_logits'],
                           runs[0][case]['decode_logits'])
        assert set(got['state']) == {k[len(f'{case}/state/'):]
                                     for k in want
                                     if k.startswith(f'{case}/state/')}
        for key, leaf in got['state'].items():
            np.testing.assert_allclose(
                leaf.float().numpy(),
                want[f'{case}/state/{key}'].astype(np.float32), **STATE_TOL)


@pytest.mark.parametrize('case', CASES)
def test_state_blocks_are_jax_shard_shapes(case, want, runs):
    for run in runs:
        for key, shape in run[case]['state_local'].items():
            shard = tuple(int(n) for n in want[f'{case}/state_shard/{key}'])
            assert shape == shard, key


def test_caches_split_the_sequence_over_data_and_heads_or_head_dim(runs):
    """zamba2's caches [2, 1, 16, H, 32]: the sequence over ``data``, the
    4 heads over ``model``, else head_dim; xlstm's mLSTM state at batch 1
    splits only dk."""
    for run in runs:
        kv4, kv3 = run['zamba2-kv4'], run['zamba2-kv3']
        for key in ('kv_k', 'kv_v'):
            assert kv4['state_placements'][key] == ['S(2)', 'S(3)']
            assert kv4['state_local'][key] == (2, 1, 8, 2, 32)
            assert kv3['state_placements'][key] == ['S(2)', 'S(4)']
            assert kv3['state_local'][key] == (2, 1, 8, 3, 16)
        assert run['xlstm']['state_placements']['mlstm'] == ['R', 'S(4)']


@pytest.mark.parametrize('case', ZAMBA)
def test_cache_writes_land_only_in_the_data_block_that_holds_pos(case,
                                                                  runs):
    ranges = set()
    for run in runs:
        got = run[case]
        start, stop = got['seq_range']
        ranges.add((start, stop))
        for pos, changed in zip(oracle.POSITIONS, got['changed']):
            assert changed == [start <= pos < stop] * 2, (pos, start, stop)
    assert ranges == {(0, 8), (8, 16)}


@pytest.mark.parametrize('case', CASES)
def test_partitioned_decode_matches_the_unpartitioned_port(case, runs):
    for run in runs:
        got = run[case]
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   got['plain_logits'].numpy(), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize('maps,placements', [
    ((2, 4, 4), ['S(1)', 'S(2)']),     # GQA: q heads 2i, 2i+1 -> kv i
    ((4, 4, 4), ['S(1)', 'S(2)']),     # one q head a kv head
    ((2, 4, 2), ['S(1)', 'R'])])       # q head 1 -> kv 1: across blocks
def test_repeat_kv_keeps_block_local_heads_split(maps, placements, runs):
    for run in runs:
        got = run['repeat_kv'][maps]
        assert got['equal']
        assert got['placements'] == placements
