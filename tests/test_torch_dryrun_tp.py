"""The op counter on DTensor programs and the partitioned dry run, on the
CPU with ``fake`` process groups (nothing is sent, every tensor on
``meta``).

  * On a fake group of 4 with a (data 2, model 2) mesh: a matmul whose
    weight is sharded 2 ways is counted at its local shapes, half the
    replicated FLOPs, and the fake-tensor run of DTensor's shape
    propagation is not counted; the functional collectives of a
    redistribution land under ``hlo_parse``'s keys at their results'
    bytes, with no FLOPs, and split off as cross-pod by their group's
    ranks; on a mesh of the card's device type DTensor's all-to-all is
    counted as one.
  * ``run_cell('yi-34b', 'train_4k', 'single', opt='n_layers=2')`` on the
    256-rank production mesh: its argument bytes are exactly the sum of
    the blocks that ``param_specs`` (parameters, each moment as its
    parameter), the replicated step and ``batch_shardings`` give one rank;
    its per-rank matmul FLOPs times 256 lie within [0.95, 1.3] of the
    same step's count with no mesh on the same padded (tp 16) parameters.
  * ``run_cell('yi-34b', 'decode_32k', 'single', opt='n_layers=2')``: its
    argument bytes are exactly the blocks that ``param_specs``,
    ``decode_state_specs`` (K and V [2, 8, 2048, 8, 128] in bfloat16,
    67,108,864 B each) and ``batch_shardings`` give one rank; its counted
    collective bytes a rank stay below what gathering one layer's K and V
    sequence whole would move (1.07e9 B), so no rank gathers the cache;
    its note reads ``partitioned``.
  * ``layers.decode_attend`` on a long-context cache (the sequence over
    ``data``, the heads or head_dim over ``model``) moves less than one
    rank's block of k in its collectives: the cache's sequence is never
    gathered; ``registry.shard_decode_inputs`` lays out whisper-base's
    decode state, and raises on a long-context request outside
    ``LONG_CONTEXT_FAMILIES``.
"""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.analysis import op_count
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import layers, registry
from repro_torch.optim import adam
from repro_torch.runtime.sharding import axes_size, distribute_like
from torch_serve_parity import one_torch_thread  # noqa: F401

AXES = ('data', 'model')
TP = 16


@pytest.fixture
def fake4():
    """A ``fake`` process group of 4 ranks (this process rank 0), torn
    down after the test (``run_cell`` starts a world of its own)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def meta(mesh, shape, placements):
    return distribute_like(torch.empty(shape, device='meta'), mesh,
                           placements)


def test_dtensor_matmul_counted_at_local_shapes(fake4):
    mesh = init_device_mesh('cpu', (2, 2), mesh_dim_names=AXES)
    # shapes of this test alone, so DTensor's shape propagation runs here
    # (its results are cached) and is seen not to count
    x = meta(mesh, (24, 40), [Replicate(), Replicate()])
    w_rep = meta(mesh, (40, 56), [Replicate(), Replicate()])
    w_tp = meta(mesh, (40, 56), [Replicate(), Shard(1)])
    rep = op_count.analyze(torch.matmul, x, w_rep)
    tp = op_count.analyze(torch.matmul, x, w_tp)
    assert rep['dot_flops'] == rep['flops'] == 2 * 24 * 40 * 56
    assert tp['dot_flops'] == tp['flops'] == rep['dot_flops'] // 2
    assert rep['n_ops'] == tp['n_ops'] == 1
    assert tp['collective_bytes'] == 0 and tp['collective_counts'] == {}


def test_functional_collectives_counted_as_collectives(fake4):
    mesh = init_device_mesh('cpu', (2, 2), mesh_dim_names=AXES)
    gathered = meta(mesh, (8, 64), [Shard(0), Replicate()])
    partial = DTensor.from_local(torch.empty((8, 32), device='meta'), mesh,
                                 [Replicate(), Partial()])

    def redistribute(t, placements):
        return lambda: t.redistribute(mesh, placements)

    cases = (('all-gather', redistribute(gathered, [Replicate()] * 2),
              8 * 64 * 4),                       # the gathered [8, 64]
             ('all-reduce', redistribute(partial, [Replicate()] * 2),
              8 * 32 * 4),
             ('reduce-scatter', redistribute(partial, [Replicate(),
                                                       Shard(0)]),
              4 * 32 * 4))                       # this rank's [4, 32]
    for key, fn, nbytes in cases:
        got = op_count.analyze(fn)
        assert got['collective_counts'] == {key: 1}, key
        assert got['collective_bytes'] == nbytes, key
        assert got['flops'] == got['dot_flops'] == 0, key
        assert got['bytes'] >= nbytes, key
    # (data 2, model 2): a data group is {0, 2}, a model group {0, 1}; in
    # pods of 2 ranks only the data group crosses a pod
    over_data = op_count.analyze(cases[0][1], pod_size=2)
    over_model = op_count.analyze(cases[1][1], pod_size=2)
    assert over_data['collective_bytes_crosspod'] == 8 * 64 * 4
    assert over_model['collective_bytes_crosspod'] == 0


def test_dtensor_all_to_all_on_a_cuda_mesh(fake4):
    """A mesh of the card's device type needs no card on a fake group; its
    shard-to-shard redistribution is DTensor's all-to-all (a CPU mesh
    falls back to an all-gather and a chunk)."""
    mesh = init_device_mesh('cuda', (2, 2), mesh_dim_names=AXES)
    x = meta(mesh, (8, 64), [Replicate(), Shard(1)])
    got = op_count.analyze(lambda: x.redistribute(mesh, [Replicate(),
                                                         Shard(0)]))
    assert got['collective_counts'] == {'all-to-all': 1}
    assert got['collective_bytes'] == 4 * 64 * 4     # this rank's [4, 64]
    assert got['flops'] == 0


@pytest.mark.parametrize('heads,split', [(4, 2), (3, 3)])
def test_decode_attend_refuses_a_head_sharded_cache(fake4, heads, split):
    """The long-context cache [1, 64, H, 32]: the sequence over ``data``,
    the heads (4) or head_dim (3 heads) over ``model``.  Its decode
    attention is counted on the fake group: every collective it runs
    moves less than one rank's block of k, so none gathers the cache's
    sequence, and the result keeps the heads' or head_dim's split."""
    mesh = init_device_mesh('cpu', (2, 2), mesh_dim_names=AXES)
    kv_pl = [Shard(1), Shard(split)]
    q = meta(mesh, (1, 1, 4, 32), [Replicate(), Shard(2)])
    kv = meta(mesh, (1, 64, heads, 32), kv_pl)
    kv = layers.repeat_kv(kv, 4, heads)   # block-local: no head gather
    assert list(kv.placements) == kv_pl
    out = []
    got = op_count.analyze(lambda: out.append(
        layers.decode_attend(q, kv, kv, 40)))
    # half the sequence, half of the 4 q heads' 4 x 32 values, float32
    block = kv.to_local().numel() * 4
    assert block == 32 * 2 * 32 * 4
    assert 0 < got['collective_bytes'] < block, got
    assert list(out[0].placements) == [Replicate(), Shard(split)]
    assert out[0].shape == (1, 1, 4, 32)


def test_encdec_ssm_and_hybrid_decode_inputs_are_not_laid_out(fake4):
    """Every family's decode inputs are laid out now (ssm and hybrid:
    ``tests/test_torch_dryrun_ssm.py``): whisper's self and cross K/V
    pairs [L, B, T, Hkv, hd] by the dense rule, batch over ``data`` and
    sequence over ``model``.  The long-context layout is for the families
    of ``LONG_CONTEXT_FAMILIES`` only; another family asking for it
    raises."""
    mesh = init_device_mesh('cpu', (2, 2), mesh_dim_names=AXES)
    cfg = get_config('whisper-base').reduced()
    state = registry.abstract_decode_state(cfg, 4, 16, 2)
    _, state, token = registry.shard_decode_inputs(
        cfg, mesh, state=state, token=torch.empty((4, 1), dtype=torch.int32,
                                                  device='meta'))
    for pair in (state['self'], state['cross']):
        for t in pair:
            assert list(t.placements) == [Shard(1), Shard(2)]
            assert tuple(t.to_local().shape) == (2, 2, 8, 2, 32)
    assert list(token.placements) == [Shard(0), Replicate()]
    for arch in ('whisper-base', 'smollm-360m', 'granite-moe-1b-a400m'):
        with pytest.raises(ValueError, match='long-context layout'):
            registry.shard_decode_inputs(get_config(arch), mesh,
                                         long_context=True)


class Mesh:
    """Shape-only stand-in of the production mesh for the spec rules."""
    shape = {'data': 16, 'model': 16}
    axis_names = AXES


def _block_bytes(shape, spec, itemsize: int) -> int:
    """The bytes of one rank's block of ``shape`` laid out by ``spec``."""
    dims = [n // (axes_size(Mesh, e) if e is not None else 1)
            for n, e in zip(shape, tuple(spec) + (None,) * len(shape))]
    return math.prod(dims) * itemsize


def counted_cell(shape: str, out_dir) -> tuple:
    """The record of yi-34b's ``shape`` cell cut to 2 layers on the
    single mesh, and its op counter's counts."""
    counters = []

    class Kept(op_count.OpCounter):
        def __init__(self, *a):
            super().__init__(*a)
            counters.append(self)

    real = dryrun.op_count.OpCounter
    dryrun.op_count.OpCounter = Kept
    try:
        rec = dryrun.run_cell('yi-34b', shape, 'single', opt='n_layers=2',
                              out_dir=out_dir)
    finally:
        dryrun.op_count.OpCounter = real
    return rec, counters[0].counts()


@pytest.fixture(scope='module')
def yi_cell(tmp_path_factory):
    return counted_cell('train_4k', tmp_path_factory.mktemp('dryrun'))


@pytest.fixture(scope='module')
def yi_decode_cell(tmp_path_factory):
    return counted_cell('decode_32k', tmp_path_factory.mktemp('dryrun'))


def test_yi_argument_bytes_are_the_specs_blocks(yi_cell):
    rec, _ = yi_cell
    cfg = dataclasses.replace(get_config('yi-34b'), n_layers=2)
    params = registry.abstract_params(cfg, TP)
    specs = registry.param_specs(cfg, params, Mesh)
    state = getattr(torch, cfg.opt_state_dtype).itemsize
    want = 4                                     # the replicated step
    for name, p in params.named_parameters():
        want += _block_bytes(p.shape, specs[name], p.element_size())
        want += 2 * _block_bytes(p.shape, specs[name], state)   # mu, nu
    batch = registry.input_specs(cfg, SHAPES['train_4k'])
    for k, spec in registry.batch_shardings(cfg, Mesh, batch).items():
        want += _block_bytes(batch[k].shape, spec, 4)
    assert rec['memory_analysis']['argument_size_in_bytes'] == want
    assert rec['roofline']['note'] == 'n_layers=2; partitioned'


def test_yi_matmul_flops_divide_by_the_mesh(yi_cell):
    _, counts = yi_cell
    cfg = dataclasses.replace(get_config('yi-34b'), n_layers=2)
    params = registry.abstract_params(cfg, TP)     # the same padding
    step, acfg = registry.make_train_step(cfg, registry.make_ctx(None, cfg))
    opt = adam.init(list(params.parameters()), acfg)
    whole = op_count.analyze(step, params, opt,
                             registry.input_specs(cfg, SHAPES['train_4k']))
    ratio = counts['dot_flops'] * 256 / whole['dot_flops']
    assert 0.95 <= ratio <= 1.3, ratio
    assert counts['collective_bytes'] > 0


def test_yi_decode_argument_bytes_are_the_specs_blocks(yi_decode_cell):
    rec, _ = yi_decode_cell
    cfg = dataclasses.replace(get_config('yi-34b'), n_layers=2)
    params = registry.abstract_params(cfg, TP)
    specs = registry.param_specs(cfg, params, Mesh)
    want = sum(_block_bytes(p.shape, specs[name], p.element_size())
               for name, p in params.named_parameters())
    sh = SHAPES['decode_32k']
    state = registry.abstract_decode_state(cfg, sh.global_batch, sh.seq_len,
                                           TP)
    s_specs = registry.decode_state_specs(cfg, state, Mesh,
                                          long_context=False)
    cache = [_block_bytes(c.shape, spec, c.element_size())
             for c, spec in zip(state, s_specs)]
    assert cache == [2 * 8 * 2048 * 8 * 128 * 2] * 2 == [67_108_864] * 2
    token = registry.input_specs(cfg, sh)['token']
    want += sum(cache) + _block_bytes(
        token.shape, registry.batch_shardings(cfg, Mesh, token), 4)
    assert rec['memory_analysis']['argument_size_in_bytes'] == want
    assert rec['roofline']['note'] == 'n_layers=2; partitioned'


def test_yi_decode_gathers_no_cache(yi_decode_cell):
    _, counts = yi_decode_cell
    cfg = get_config('yi-34b')
    sh = SHAPES['decode_32k']
    # one layer's K and V, its rows' block (batch over data) with the
    # sequence whole, in bfloat16
    layer_kv = (2 * sh.global_batch // Mesh.shape['data'] * sh.seq_len
                * cfg.n_kv_heads * cfg.resolved_head_dim() * 2)
    assert layer_kv == 1_073_741_824
    assert 0 < counts['collective_bytes'] < layer_kv
    assert counts['collective_counts']['all-reduce'] > 0
