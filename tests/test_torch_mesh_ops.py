"""The port's per-rank mesh bodies against the JAX package's ``shard_map``
bodies on 4 forced host devices: the expert-parallel MoE FFN,
``psum_compressed`` and GPipe.

The JAX side runs once, in a process of its own (``jax_mesh_oracle.run``:
the test process holds JAX with one device); the port runs on a 4-rank
gloo group of spawned processes that never import JAX
(``torch_mesh_ranks``).  Bounds: the EP drop fraction exactly (on a
fixture where per-rank capacity drops tokens and the local path drops
none), the EP output within 1e-5 and its gradients within 1e-5 of each
leaf's largest; ``psum_compressed``'s sums and residuals exactly; GPipe
within 1e-6 of the largest activation, of JAX's run and of the
unpipelined stack.  Every rank must hold the same values.
"""
import numpy as np
import pytest
import torch

import jax_mesh_oracle as oracle
import torch_mesh_ranks as ranks

EP_TOL, GRAD_TOL, GPIPE_TOL = 1e-5, 1e-5, 1e-6


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp('oracle') / 'ops.npz'
    oracle.run(path, 'moe', 'psum', 'gpipe')
    return str(path)


@pytest.fixture(scope='module')
def jax_out(npz):
    return ranks.load(npz)


@pytest.fixture(scope='module')
def moe_out(npz, tmp_path_factory):
    return ranks.spawn(ranks.moe_rank, tmp_path_factory.mktemp('moe'), npz)


def _same_on_every_rank(outs, get):
    first = get(outs[0])
    for o in outs[1:]:
        assert torch.equal(get(o), first)
    return first


def test_ep_drop_is_exact_where_per_rank_capacity_drops(jax_out, moe_out):
    drop = _same_on_every_rank(moe_out, lambda o: o['ep'][1])
    local = _same_on_every_rank(moe_out, lambda o: o['local'][1])
    want, want_local = jax_out['moe/ep/drop'], jax_out['moe/local/drop']
    assert float(want) > 0.0 and float(want) != float(want_local)
    assert drop.dtype == torch.float32
    assert float(drop) == float(want)
    assert float(local) == float(want_local)


def test_ep_output_matches_jax(jax_out, moe_out):
    for path, key in (('ep', 'moe/ep/out'), ('local', 'moe/local/out')):
        out = _same_on_every_rank(moe_out, lambda o: o[path][0])
        np.testing.assert_allclose(out.numpy(), jax_out[key], atol=EP_TOL,
                                   rtol=0)


def test_ep_gradients_match_jax(jax_out, moe_out):
    got = moe_out[0]['grad']
    np.testing.assert_allclose(got['out'].numpy(), jax_out['moe_grad/ep/out'],
                               atol=EP_TOL, rtol=0)
    assert float(got['drop']) == float(jax_out['moe_grad/ep/drop'])
    leaves = {'x': (got['gx'], jax_out['moe_grad/ep/gx'])}
    for k, g in got['gp'].items():
        leaves[k] = (g, jax_out[f'moe_grad/ep/gp/{k}'])
    assert set(leaves) == {'x', 'router', 'w_up', 'w_gate', 'w_down'}
    for k, (g, want) in leaves.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=k)
        for o in moe_out[1:]:
            other = o['grad']['gx'] if k == 'x' else o['grad']['gp'][k]
            assert torch.equal(other, g), k


def test_psum_compressed_equals_jax_exactly(jax_out, npz, tmp_path):
    outs = ranks.spawn(ranks.psum_rank, tmp_path, npz)
    for rank, out in enumerate(outs):
        for k in oracle.PSUM_SHAPES:
            np.testing.assert_array_equal(out['sum'][k].numpy(),
                                          jax_out[f'psum/sum/{k}'][rank])
            np.testing.assert_array_equal(out['res'][k].numpy(),
                                          jax_out[f'psum/res/{k}'][rank])
            assert torch.equal(out['sum'][k], outs[0]['sum'][k])


def test_gpipe_matches_jax_and_the_unpipelined_stack(jax_out, npz, tmp_path):
    outs = ranks.spawn(ranks.gpipe_rank, tmp_path, npz)
    want = jax_out['gpipe/y']
    tol = GPIPE_TOL * np.abs(want).max()
    np.testing.assert_array_equal(want, jax_out['gpipe/ref'])
    y = _same_on_every_rank(outs, lambda o: o['y'])
    np.testing.assert_allclose(y.numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(y.numpy(), outs[0]['ref'].numpy(), atol=tol,
                               rtol=0)
