"""The port's partitioned encoder-decoder program (whisper-base, recipe
``dp``) against the JAX package's, on 4 gloo ranks and 4 forced host
devices (the oracle runs in processes of its own).

Reduced whisper-base (2 encoder and 2 decoder layers, d_model 64,
head_dim 32) with 4 heads and with 3 on (data 2, model 2): 4 heads split
2 a rank over ``model``; 3 are padded to 4 and the padded head is masked
on the mesh, as whisper-base's 8 heads on 16 ranks are.  Both packages
start from JAX's weights (``interop.lm_params_on_mesh``: under ``dp``
every parameter replicated) and the same seeded tokens, labels and
frames, laid out by ``param_specs``, ``batch_shardings`` and
``decode_state_specs`` (the self and cross K/V pairs [L, B, T, Hkv, hd]:
batch over ``data``, sequence over ``model``), the Adam state as its
parameters: JAX's programs jitted with those ``in_shardings`` and
``out_shardings``, the port's registry steps on the DTensor layout.

Checked: three train losses and the gradient norms of the two steps that
no update precedes, the prefill's logits, ``prepare_cross``'s pair and the
decode logits at positions 0..11 (over both blocks of the sequence)
against JAX's partitioned program, and every self and cross leaf of the
decode state; every parameter's, moment's and state leaf's local block
exactly JAX's ``shard_shape``; the self-attention writes landing only in
the ``model`` rank whose block holds ``pos``; the trained state identical
on every rank; the partitioned loss and decode against the port's
unpartitioned ones on the same ranks.

Tolerance: 1e-5 absolute everywhere, as for the dense family
(``tests/test_torch_mesh_tp.py``).  ``flash_attention`` rounds Q, K, P
and V to bfloat16, so a split sum's float32 ulp could flip one by a
bfloat16 ulp (``torch_lm_parity.FLIP_TOL``); on these fixtures none did:
the largest gap to JAX's partitioned program is 2.9e-6 (a loss), within
JAX's own gap between its partitioned and unpartitioned prefills
(2.3e-6 to 3.1e-6).
"""
import numpy as np
import pytest
import torch

import jax_encdec_oracle as oracle
import torch_encdec_ranks as encdec_ranks
import torch_mesh_ranks as ranks

TOL = 1e-5
CASES = tuple(oracle.CASES)


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'encdec.npz'
    oracle.run(path, *CASES)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    return ranks.spawn(encdec_ranks.encdec_rank,
                       tmp_path_factory.mktemp('encdec'), npz, CASES)


def _jax_key(name: str) -> tuple:
    """A port parameter name as the JAX leaf key and its count of stacked
    layer axes (``dec.1.cross.wq`` -> (``dec/cross/wq``, 1))."""
    parts = name.split('.')
    return ('/'.join(p for p in parts if not p.isdigit()),
            sum(p.isdigit() for p in parts))


@pytest.mark.parametrize('case', CASES)
def test_partitioned_losses_match_jax(case, want, runs):
    for run in runs:
        got = run[case]
        np.testing.assert_allclose(got['loss'], want[f'{case}/loss'],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got['grad_norm'][:2],
                                   want[f'{case}/grad_norm'][:2], atol=TOL,
                                   rtol=0)
        assert got['loss'] == runs[0][case]['loss']
        for pl in got['metric_placements']:
            assert set(pl) == {'R'}, pl


@pytest.mark.parametrize('case', CASES)
def test_partitioned_prefill_matches_jax(case, want, runs):
    for run in runs:
        got = run[case]
        assert set(got['logits_placements']) == {'R'}
        np.testing.assert_allclose(got['logits'].numpy(),
                                   want[f'{case}/logits'], atol=TOL, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_cross_pair_matches_jax(case, want, runs):
    for run in runs:
        got = run[case]
        # prepare_cross's pair as cross_kv's kv_cache lays it: batch over
        # data, sequence over model (the stack's dims 1 and 2)
        assert got['cross_placements'] == ['S(1)', 'S(2)']
        for i, c in enumerate(got['cross']):
            np.testing.assert_allclose(c.numpy(), want[f'{case}/cross/{i}'],
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_partitioned_decode_matches_jax(case, want, runs):
    for run in runs:
        got = run[case]
        assert set(got['decode_placements']) == {'R'}
        assert got['same_state']
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   want[f'{case}/decode_logits'], atol=TOL,
                                   rtol=0)
        assert torch.equal(got['decode_logits'],
                           runs[0][case]['decode_logits'])
        assert set(got['state']) == {'self/0', 'self/1', 'cross/0',
                                     'cross/1'}
        for key, leaf in got['state'].items():
            np.testing.assert_allclose(leaf.numpy(),
                                       want[f'{case}/state/{key}'],
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_local_blocks_are_jax_shard_shapes(case, want, runs):
    for run in runs:
        got = run[case]
        names = list(got['local'])
        assert len(got['moment_local']) == len(names)
        for name, (mu, nu) in zip(names, got['moment_local']):
            key, stacked = _jax_key(name)
            shard = tuple(int(n) for n in want[f'{case}/shard/{key}'])
            assert got['local'][name] == shard[stacked:], name
            assert mu == nu == shard[stacked:], name
        assert got['step'] == (oracle.STEPS, ['R', 'R'])
        for key, shape in got['state_local'].items():
            shard = tuple(int(n) for n in want[f'{case}/state_shard/{key}'])
            assert shape == shard, key
            # the stack [L, B, T, Hkv, hd]: batch over data, sequence
            # over model
            assert got['state_placements'][key] == ['S(1)', 'S(2)'], key


def test_self_writes_land_only_in_the_block_that_holds_pos(runs):
    for case in CASES:
        ranges = set()
        for run in runs:
            got = run[case]
            start, stop = got['seq_range']
            ranges.add((start, stop))
            for pos, changed in zip(oracle.POSITIONS, got['changed']):
                assert changed == [start <= pos < stop] * 2, (pos, start,
                                                              stop)
        assert ranges == {(0, 8), (8, 16)}


@pytest.mark.parametrize('case', CASES)
def test_trained_state_is_identical_on_every_rank(case, want, runs):
    first = runs[0][case]
    for run in runs[1:]:
        got = run[case]
        assert list(got['params']) == list(first['params'])
        for name, p in got['params'].items():
            assert torch.equal(p, first['params'][name]), name
        for tree in ('mu', 'nu'):
            for a, b in zip(got[tree], first[tree]):
                assert torch.equal(a, b), tree
    for name, p in first['params'].items():    # every leaf of JAX's tree
        key, stacked = _jax_key(name)
        assert p.shape == want[f'{case}/params/{key}'].shape[stacked:]


@pytest.mark.parametrize('case', CASES)
def test_partitioned_steps_match_the_unpartitioned_port(case, runs):
    for run in runs:
        got = run[case]
        assert abs(got['loss'][0] - got['plain_loss']) <= TOL
        np.testing.assert_allclose(got['decode_logits'].numpy(),
                                   got['plain_decode_logits'].numpy(),
                                   atol=TOL, rtol=0)
