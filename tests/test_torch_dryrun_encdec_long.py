"""The last cells to count the partitioned program: whisper-base (recipe
``dp``) at ``train_4k``, ``prefill_32k`` and ``decode_32k``, and the
``long_500k`` decode of xlstm-1.3b and zamba2-1.2b (the long-context
layout), in the dry run on the CPU with a ``fake`` process group of 256
or 512 ranks (nothing is sent, every tensor on ``meta``).

whisper-base cut to 1 encoder and 1 decoder layer, zamba2-1.2b to 6
layers (one attention point), xlstm-1.3b to 8 (one super-block):

  * the decode state ``build_lm_cell`` lays out, a rank's blocks equal to
    the JAX package's ``shard_shape`` of its ``decode_state_specs`` on the
    single mesh (data 16, model 16), ``long_context`` at ``long_500k``:
    whisper's self and cross pairs [1, 128, 32768, 8, 64] as [1, 8, 2048,
    8, 64]; zamba2's caches [1, 1, 524288, 32, 64] as [1, 1, 32768, 2,
    64] (the sequence over ``data``, the heads over ``model``); xlstm's
    mLSTM state at batch 1 as dk over ``model`` only;
  * the records: the note reads ``partitioned`` and ``useful_ratio`` is
    at least 10x the replicated program's (about 1 / chips) for whisper,
    4x for ``long_500k`` (at batch 1 only the attention splits over
    ``data``).  Each cell on the single mesh and on the multi mesh (pod
    2, data 16, model 16), but whisper's ``prefill_32k``: its
    32,768-position flash attention takes 42-59 s to count a mesh on one
    CPU core, more than the rest of the file together, so its rows are
    counted by ``python -m repro_torch.launch.dryrun`` only
    (``PERF.md``), and its partitioned prefill is held against JAX's on 4
    gloo ranks (``tests/test_torch_mesh_encdec.py``).
"""
import dataclasses
import math

import jax
import pytest
from torch.distributed.tensor import DTensor

from repro.configs import get_config as jax_config
from repro.models import registry as jax_registry
from repro_torch.launch import dryrun
from repro_torch.tree import leaves
from torch_serve_parity import one_torch_thread  # noqa: F401

CUTS = {'whisper-base': 'n_layers=1,enc_layers=1',
        'zamba2-1.2b': 'n_layers=6', 'xlstm-1.3b': 'n_layers=8'}
CELLS = (('whisper-base', 'train_4k', 'single'),
         ('whisper-base', 'train_4k', 'multi'),
         ('whisper-base', 'decode_32k', 'single'),
         ('whisper-base', 'decode_32k', 'multi'),
         ('zamba2-1.2b', 'long_500k', 'single'),
         ('zamba2-1.2b', 'long_500k', 'multi'),
         ('xlstm-1.3b', 'long_500k', 'single'),
         ('xlstm-1.3b', 'long_500k', 'multi'))
DECODES = (('whisper-base', 'decode_32k'), ('zamba2-1.2b', 'long_500k'),
           ('xlstm-1.3b', 'long_500k'))


class Mesh:
    """Shape-only stand-in of the single production mesh for the JAX
    package's spec rules."""
    shape = {'data': 16, 'model': 16}
    axis_names = ('data', 'model')


def _cut(arch: str) -> dict:
    return {k: int(v) for k, v in (kv.split('=')
                                   for kv in CUTS[arch].split(','))}


def _state(arch: str, shape: str):
    """The decode state ``build_lm_cell`` lays out on the single mesh (a
    fake world of its own, torn down after)."""
    import torch.distributed as dist
    dryrun.init_fake_world(dryrun.MESH_RANKS['single'])
    try:
        mesh = dryrun.dry_run_mesh('single', 'partitioned')
        _, args, _ = dryrun.build_lm_cell(arch, shape, mesh, CUTS[arch])
    finally:
        dist.destroy_process_group()
    return args[2]


def _jax_blocks(arch: str, shape: str) -> list:
    """JAX's ``shard_shape`` of every decode state leaf on the single
    mesh, in the tree's order."""
    from repro.configs.base import SHAPES
    sh = SHAPES[shape]
    cfg = dataclasses.replace(jax_config(arch), **_cut(arch))
    state = jax_registry.abstract_decode_state(cfg, sh.global_batch,
                                               sh.seq_len, 16)
    specs = jax_registry.decode_state_specs(
        cfg, state, Mesh, long_context=shape == 'long_500k')
    out = []
    for leaf, spec in zip(jax.tree_util.tree_leaves(state),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec))):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out.append(tuple(
            n // math.prod(Mesh.shape[a] for a in
                           ((e,) if isinstance(e, str) else e or ()))
            for n, e in zip(leaf.shape, entries)))
    return out


@pytest.mark.parametrize('arch,shape', DECODES)
def test_decode_state_blocks_are_jax_shard_shapes(arch, shape):
    state = leaves(_state(arch, shape), lambda x: hasattr(x, 'shape'))
    assert all(isinstance(t, DTensor) for t in state)
    got = [tuple(t.to_local().shape) for t in state]
    assert got == _jax_blocks(arch, shape)
    want = {'whisper-base': (1, 8, 2048, 8, 64),
            'zamba2-1.2b': (1, 1, 32768, 2, 64),
            'xlstm-1.3b': (1, 7, 1, 4, 64, 1025)}[arch]
    assert want in got


@pytest.mark.parametrize('arch,shape,mesh', CELLS)
def test_cells_count_the_partitioned_program(arch, shape, mesh, tmp_path):
    chips = dryrun.MESH_RANKS[mesh]
    rec = dryrun.run_cell(arch, shape, mesh, opt=CUTS[arch],
                          out_dir=tmp_path)
    row = rec['roofline']
    assert row['note'] == f'{CUTS[arch]}; partitioned'
    # the replicated program read about 1 / chips
    least = (4 if shape == 'long_500k' else 10) / chips
    assert row['useful_ratio'] > least, row['useful_ratio']
