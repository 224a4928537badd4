"""The partitioned recurrent programs (recipe ``ssm``) in the dry run, on
the CPU with a ``fake`` process group of 256 ranks (nothing is sent,
every tensor on ``meta``).

xlstm-1.3b cut to 8 layers (one super-block of 7 mLSTM blocks and an
sLSTM block; a depth that ``slstm_every`` does not divide has no
super-block and cannot decode) and zamba2-1.2b cut to 6 layers (one
attention point) on the single production mesh (data 16, model 16):

  * the layout ``build_lm_cell`` gives the train step: each parameter's
    local block is the JAX package's ``shard_shape`` of its
    ``param_specs`` on that mesh (xlstm's ``wq`` [4096/16, 4096/16], its
    ``w_h_blocks`` whole);
  * the ``decode_32k`` state blocks a rank: xlstm's mLSTM state [1, 7, 8,
    4, 64, 1025] (batch over ``data``, dk over ``model``: 4 heads do not
    divide 16), its sLSTM h and c [1, 8, 256]; zamba2's caches [1, 8,
    2048, 32, 64], SSD state [6, 8, 4, 64, 64] (heads over ``model``),
    conv window [6, 8, 3, 264] (channels over ``model``);
  * the ``train_4k`` and ``decode_32k`` records: the note reads
    ``partitioned``, ``train_4k``'s ``useful_ratio`` is above 25 / 256
    and ``decode_32k``'s at least 10x the replicated program's (about
    1 / 256);
  * a ``model`` axis that does not divide the Mamba2 heads raises, where
    every rank would otherwise run them all.
"""
import dataclasses
import math

import jax
import pytest
from torch.distributed.tensor import DTensor

from repro.configs import get_config as jax_config
from repro.models import registry as jax_registry
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import mamba2
from torch_serve_parity import one_torch_thread  # noqa: F401

CUTS = {'xlstm-1.3b': 'n_layers=8', 'zamba2-1.2b': 'n_layers=6'}
CHIPS = dryrun.MESH_RANKS['single']


class Mesh:
    """Shape-only stand-in of the production mesh for the JAX package's
    spec rules."""
    shape = {'data': 16, 'model': 16}
    axis_names = ('data', 'model')


def _layout(arch: str, shape: str):
    """The arguments ``build_lm_cell`` lays out for ``shape`` on the single
    mesh (a fake world of its own, torn down after)."""
    import torch.distributed as dist
    dryrun.init_fake_world(CHIPS)
    try:
        mesh = dryrun.dry_run_mesh('single', 'partitioned')
        _, args, _ = dryrun.build_lm_cell(arch, shape, mesh, CUTS[arch])
    finally:
        dist.destroy_process_group()
    return args


def _jax_blocks(arch: str) -> dict:
    """JAX's ``shard_shape`` of every parameter leaf on the production
    mesh, by its ``a/b/c`` key, from ``param_specs`` on the abstract
    tree."""
    cfg = dataclasses.replace(jax_config(arch),
                              n_layers=int(CUTS[arch].split('=')[1]))
    tree = jax.eval_shape(lambda: jax_registry.init_params(
        jax.random.PRNGKey(0), cfg, 16))
    specs = jax_registry.param_specs(cfg, tree, Mesh)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out['/'.join(e.key for e in path)] = tuple(
            n // math.prod(Mesh.shape[a] for a in
                           ((e,) if isinstance(e, str) else e or ()))
            for n, e in zip(leaf.shape, entries))
    return out


@pytest.mark.parametrize('arch', tuple(CUTS))
def test_parameter_blocks_are_jax_shard_shapes(arch):
    params = _layout(arch, 'train_4k')[0]
    want = _jax_blocks(arch)
    seen = set()
    for name, p in params.named_parameters():
        assert isinstance(p, DTensor), name
        parts = name.split('.')
        key = '/'.join(q for q in parts if not q.isdigit())
        stacked = sum(q.isdigit() for q in parts)
        assert tuple(p.to_local().shape) == want[key][stacked:], name
        seen.add(key)
    assert seen == set(want)
    if arch == 'xlstm-1.3b':
        blk = params.blocks[0]
        assert tuple(blk.mlstm[0].wq.to_local().shape) == (256, 256)
        assert tuple(blk.slstm.w_h_blocks.to_local().shape) == (4, 1024,
                                                                4096)


def test_decode_state_blocks_a_rank():
    _, _, state, pos = _layout('xlstm-1.3b', 'decode_32k')
    assert pos == 32_767
    assert all(isinstance(v, DTensor) for v in state.values())
    assert tuple(state['mlstm'].to_local().shape) == (1, 7, 8, 4, 64, 1025)
    for key in ('slstm_h', 'slstm_c'):
        assert tuple(state[key].to_local().shape) == (1, 8, 256)
    _, _, state, _ = _layout('zamba2-1.2b', 'decode_32k')
    for key in ('kv_k', 'kv_v'):
        assert tuple(state[key].to_local().shape) == (1, 8, 2048, 32, 64)
    assert tuple(state['ssm']['ssm'].to_local().shape) == (6, 8, 4, 64, 64)
    assert tuple(state['ssm']['conv'].to_local().shape) == (6, 8, 3, 264)


@pytest.mark.parametrize('arch', tuple(CUTS))
@pytest.mark.parametrize('shape', ('train_4k', 'decode_32k'))
def test_cells_count_the_partitioned_program(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, 'single', opt=CUTS[arch],
                          out_dir=tmp_path)
    row = rec['roofline']
    assert row['note'] == f'{CUTS[arch]}; partitioned'
    # the replicated program read about 1 / 256 = 0.0039
    least = 25 / CHIPS if shape == 'train_4k' else 10 / CHIPS
    assert row['useful_ratio'] > least, row['useful_ratio']


def test_mamba2_heads_that_model_does_not_divide_raise():
    class Mesh3:
        shape = {'data': 2, 'model': 3}
        axis_names = ('data', 'model')

    with pytest.raises(ValueError, match='does not divide the 64 Mamba2'):
        mamba2._heads(get_config('zamba2-1.2b'), Mesh3)
