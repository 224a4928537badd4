"""The partitioned MoE program in the dry run, on the CPU with a ``fake``
process group of 256 ranks (nothing is sent, every tensor on ``meta``).

granite-moe-1b-a400m cut to 2 layers on the single production mesh (data
16, model 16), recipe ``ep``:

  * the layout ``build_lm_cell`` gives the train step: each expert weight
    a rank's block of 2 of the 32 experts with a sixteenth of its d_model
    rows, ``[E/16, d/16, f]`` and ``[E/16, f, d/16]`` (the JAX package's
    ``shard_shape`` of ``P('model', 'data', None)`` and ``P('model', None,
    'data')``), the router whole, the shared submodules by the ``tp``
    table;
  * the decode cell's caches ``[2, 1, 8, 2048, 8, 64]`` a rank (batch over
    ``data``, sequence over ``model``);
  * the ``train_4k`` and ``decode_32k`` records: the note reads
    ``partitioned`` and ``useful_ratio`` stays far above the replicated
    program's 1 / 256.
"""
import pytest
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from torch_serve_parity import one_torch_thread  # noqa: F401

ARCH, OPT = 'granite-moe-1b-a400m', 'n_layers=2'
CHIPS = dryrun.MESH_RANKS['single']


def _layout(shape: str):
    """The arguments ``build_lm_cell`` lays out for ``shape`` on the single
    mesh (a fake world of its own, torn down after)."""
    import torch.distributed as dist
    dryrun.init_fake_world(CHIPS)
    try:
        mesh = dryrun.dry_run_mesh('single', 'partitioned')
        _, args, _ = dryrun.build_lm_cell(ARCH, shape, mesh, OPT)
    finally:
        dist.destroy_process_group()
    return args


def test_expert_blocks_are_a_rank_s_share():
    params = _layout('train_4k')[0]
    cfg = get_config(ARCH)
    e, d, f = cfg.n_experts // 16, cfg.d_model // 16, cfg.d_ff
    want = {'w_up': (e, d, f), 'w_gate': (e, d, f), 'w_down': (e, f, d),
            'router': (cfg.d_model, cfg.n_experts)}
    seen = set()
    for name, p in params.named_parameters():
        assert isinstance(p, DTensor), name
        leaf = name.split('.')[-1]
        if '.moe.' in name and leaf in want:
            assert tuple(p.to_local().shape) == want[leaf], name
            seen.add(leaf)
    assert seen == set(want)


def test_decode_caches_are_a_rank_s_block():
    _, _, state, pos = _layout('decode_32k')
    assert pos == 32_767
    for cache in state:
        assert isinstance(cache, DTensor)
        assert tuple(cache.to_local().shape) == (2, 1, 8, 2048, 8, 64)


@pytest.mark.parametrize('shape', ('train_4k', 'decode_32k'))
def test_moe_cells_count_the_partitioned_program(shape, tmp_path):
    rec = dryrun.run_cell(ARCH, shape, 'single', opt=OPT, out_dir=tmp_path)
    row = rec['roofline']
    assert row['note'] == f'{OPT}; partitioned'
    # the replicated program read about 1 / 256 = 0.0039
    assert row['useful_ratio'] > 25 / CHIPS, row['useful_ratio']
    assert rec['memory_analysis']['argument_size_in_bytes'] < 2 ** 30
