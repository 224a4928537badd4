"""The port's partitioned decode step against the JAX package's, on 4 gloo
ranks and 4 forced host devices (the oracle runs in a process of its own).

Reduced smollm-360m (recipe ``dp``) and reduced yi-34b (recipe ``tp``), 2
layers, 2 kv heads, head_dim 32, float32, on (data 2, model 2): batch 4
and caches of 16 positions, so each rank holds 2 rows and 8 positions of
each cache.  Both packages start from JAX's weights and zeroed caches,
laid out by ``param_specs``, ``decode_state_specs`` and
``batch_shardings``: JAX's decode step jitted with those
``in_shardings`` and ``out_shardings`` (logits replicated, caches as
they came), the port's ``registry.make_decode_step`` on the DTensor
layout of ``registry.shard_decode_inputs``.  One step at each position
0..11 (the writes land in both blocks of the sequence and attention
crosses the boundary), then one at 20, whose write clamps to position 15,
as ``dynamic_update_slice`` clamps a start past the end.

JAX's partitioned program drops that write: XLA's partitioner does not
clamp a start past the end of a sharded dimension, so no rank writes
(the same steps jitted with no shardings write at 15).  The port writes
at 15 in both its programs; one test pins the reference's behaviour
(ROADMAP queue 3), and the clamp step is held against JAX's unpartitioned
step.

Checked: every step's logits within 1e-5 absolute of JAX's (the bound
``tests/test_torch_mesh_tp.py`` holds the partitioned prefill logits
to): the partitioned step's at 0..11, the unpartitioned step's at 20;
the caches gathered within 1e-5 absolute +
1e-5 relative (``tests/test_torch_lm_models.py``'s bound for the
unpartitioned decode) of JAX's unpartitioned caches, and of its
partitioned caches at every position but 15; each cache's local block
exactly JAX's ``shard_shape``; a step changes the blocks of the ranks
whose sequence holds its write and leaves every other rank's bit for bit;
the step returns the state it was given (the writes land in the stacked
caches' storage); the logits equal on every rank; the partitioned logits
within 1e-5 of the unpartitioned port's on the same inputs, and so are
those of the layout on (data 4, model 1), where each rank keeps its row's
whole sequence and runs the plain softmax.
"""
import numpy as np
import pytest

import jax_decode_oracle as oracle
import torch_decode_ranks as decode_ranks
import torch_mesh_ranks as ranks

TOL = 1e-5
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = oracle.ARCHS


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'decode.npz'
    oracle.run(path, *ARCHS)
    return str(path)


@pytest.fixture(scope='module')
def want(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def runs(npz, tmp_path_factory):
    return ranks.spawn(decode_ranks.decode_rank,
                       tmp_path_factory.mktemp('decode'), npz, ARCHS)


def _clamped(positions) -> np.ndarray:
    """Whether each step's start lies past the end of the caches."""
    return np.asarray(positions) >= oracle.MAX_SEQ


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_decode_logits_match_jax(arch, want, runs):
    clamped = _clamped(oracle.POSITIONS)
    assert clamped.any() and not clamped.all()
    # the partitioned program's steps, and where it drops the clamped
    # write, the unpartitioned program's
    ref = np.where(clamped[:, None, None], want[f'{arch}/plain_logits'],
                   want[f'{arch}/logits'])
    for run in runs:
        got = run[arch]
        assert set(got['logits_placements']) == {'R'}
        assert got['logits'].shape == ref.shape
        np.testing.assert_allclose(got['logits'].numpy(), ref, atol=TOL,
                                   rtol=0)
        assert (got['logits'] == runs[0][arch]['logits']).all()


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_caches_match_jax(arch, want, runs):
    last = oracle.MAX_SEQ - 1
    for run in runs:
        got = run[arch]
        for cache, key in zip(got['caches'], 'kv'):
            np.testing.assert_allclose(cache.numpy(),
                                       want[f'{arch}/plain_{key}'],
                                       **CACHE_TOL)
            np.testing.assert_allclose(cache.numpy()[:, :, :last],
                                       want[f'{arch}/{key}'][:, :, :last],
                                       **CACHE_TOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_reference_partitioned_write_drops_a_clamped_start(arch, want):
    """JAX's partitioned step at position 20 leaves position 15 of every
    cache unwritten, where its unpartitioned step writes there; the two
    agree on every step before."""
    last = oracle.MAX_SEQ - 1
    clamped = _clamped(oracle.POSITIONS)
    np.testing.assert_allclose(want[f'{arch}/logits'][~clamped],
                               want[f'{arch}/plain_logits'][~clamped],
                               atol=TOL, rtol=0)
    gap = np.abs(want[f'{arch}/logits'][clamped]
                 - want[f'{arch}/plain_logits'][clamped]).max()
    assert gap > 1e-3, gap
    for key in 'kv':
        assert not want[f'{arch}/{key}'][:, :, last].any()
        assert want[f'{arch}/plain_{key}'][:, :, last].all()


@pytest.mark.parametrize('arch', ARCHS)
def test_cache_blocks_are_jax_shard_shapes(arch, want, runs):
    shard = tuple(int(n) for n in want[f'{arch}/shard'])
    assert shard == (2, oracle.BATCH // 2, oracle.MAX_SEQ // 2, 2, 32)
    ranges = set()
    for run in runs:
        got = run[arch]
        assert got['local'] == [shard, shard]
        assert got['cache_placements'] == ['S(1)', 'S(2)']
        ranges.add(got['seq_range'])
    assert ranges == {(0, 8), (8, 16)}


@pytest.mark.parametrize('arch', ARCHS)
def test_write_lands_only_in_the_block_that_holds_pos(arch, runs):
    for run in runs:
        got = run[arch]
        assert got['same_state']
        start, stop = got['seq_range']
        for pos, changed in zip(oracle.POSITIONS, got['changed']):
            at = min(pos, oracle.MAX_SEQ - 1)
            assert changed == [start <= at < stop] * 2, (pos, start, stop)


@pytest.mark.parametrize('arch', ARCHS)
def test_partitioned_decode_matches_the_unpartitioned_port(arch, runs):
    for run in runs:
        got = run[arch]
        np.testing.assert_allclose(got['logits'].numpy(),
                                   got['plain_logits'].numpy(), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(got['whole_seq_logits'].numpy(),
                                   got['plain_logits'].numpy(), atol=TOL,
                                   rtol=0)
