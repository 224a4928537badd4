"""The port's sharding rules (``runtime.sharding``, ``models.registry``'s
specs, ``runtime.elastic``'s plans) against the JAX package's, on the
shape-only mesh stand-in of ``tests/test_sharding.py``.

Specs are compared entry for entry.  A parameter of the port is one
layer's slice of a stacked leaf of the JAX package (``blocks.3.mlstm.2.wq``
is ``blocks/mlstm/wq[3, 2]``), so its spec is the JAX leaf's less the
leading stacked entries, which are always ``None``.  No process group is
needed: the rules read only the mesh's axis names and sizes.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_LM_ARCHS, get_config as jget
from repro.launch import mesh as jmesh
from repro.models import registry as jreg
from repro.runtime import elastic as jel
from repro.runtime import sharding as jsh

from repro_torch.configs import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry as treg
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import sharding as tsh
from repro_torch.runtime.sharding import P


class FakeMesh:
    """Shape-only stand-in (the rules touch only .shape / .axis_names)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh(data=16, model=16)
MESHES = {'pod1': MESH, 'pod2': FakeMesh(pod=2, data=16, model=16)}
FAMILY_ARCHS = {}
for _a in ALL_LM_ARCHS:
    FAMILY_ARCHS.setdefault(jget(_a).family, _a)


def _is_jspec(x) -> bool:
    return isinstance(x, JP)


def jax_leaves(tree, is_leaf=None) -> dict:
    """``{'a.b.c': leaf}`` of a JAX tree (sequence indices as ``#i``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        keys = [str(e.key) if hasattr(e, 'key') else f'#{e.idx}'
                for e in path]
        out['.'.join(keys)] = leaf
    return out


# --- adaptive_spec and the mesh helpers --------------------------------------

FIXTURES = [((256, 4096, 1024), [(0, ('data',)), (1, 'model')]),
            ((15, 4096), [(0, 'model'), (1, 'model')]),
            ((64, 64), [(0, 'model'), (1, 'model')]),
            ((4, 4, 64), [(-1, 'model')])]


@pytest.mark.parametrize('shape, assignments', FIXTURES)
def test_adaptive_spec_fixtures_equal_jax(shape, assignments):
    got = tsh.adaptive_spec(shape, MESH, assignments)
    assert isinstance(got, P)
    assert tuple(got) == tuple(jsh.adaptive_spec(shape, MESH, assignments))


def test_adaptive_spec_fixtures_as_test_sharding_states():
    assert tsh.adaptive_spec((256, 4096, 1024), MESH,
                             FIXTURES[0][1]) == P(('data',), 'model')
    assert tsh.adaptive_spec((15, 4096), MESH, FIXTURES[1][1]) == \
        P(None, 'model')
    assert tsh.adaptive_spec((64, 64), MESH, FIXTURES[2][1]) == P('model')
    assert tsh.adaptive_spec((4, 4, 64), MESH, FIXTURES[3][1]) == \
        P(None, None, 'model')


@settings(max_examples=80, deadline=None)
@given(st.lists(st.integers(1, 512), min_size=1, max_size=4),
       st.lists(st.tuples(st.integers(-4, 3),
                          st.sampled_from(['data', 'model', 'pod', None,
                                           ('pod', 'data'),
                                           ('data', 'model')])),
                max_size=4),
       st.sampled_from(sorted(MESHES)))
def test_adaptive_spec_equals_jax_on_shared_draws(shape, assignments, mesh):
    m = MESHES[mesh]
    got = tsh.adaptive_spec(shape, m, assignments)
    assert tuple(got) == tuple(jsh.adaptive_spec(shape, m, assignments))
    for entry in got:
        if entry is not None:
            assert tsh.axes_size(m, entry) == jsh.axes_size(m, entry)


@pytest.mark.parametrize('mesh', sorted(MESHES))
def test_mesh_helpers_equal_jax(mesh):
    m = MESHES[mesh]
    assert tsh.batch_axes(m) == jsh.batch_axes(m)
    assert tsh.all_axes(m) == jsh.all_axes(m)
    for axes in ('data', 'model', 'pod', ('pod', 'data'), ('data', 'model'),
                 ('pod', 'data', 'model'), 'devices'):
        assert tsh.axes_size(m, axes) == jsh.axes_size(m, axes)
    assert (tsh.batch_axes(None), tsh.all_axes(None),
            tsh.axes_size(None, 'model')) == ((), (), 1)


def test_shard_ctx_hooks_leave_plain_tensors_and_tp_follows_the_mesh():
    cfg = tget('yi-34b').reduced()
    ctx = treg.make_ctx(MESH, cfg, long_context=True)
    jctx = jreg.make_ctx(MESH, jget('yi-34b').reduced(), long_context=True)
    assert (ctx.recipe, ctx.tp, ctx.seq_shard_kv) == \
        (jctx.recipe, jctx.tp, jctx.seq_shard_kv) == ('tp', 16, True)
    x = torch.ones(2, 32, 4, 8)
    for hook in ('btd', 'bthd', 'btf', 'btv', 'kv_cache', 'ssm_state',
                 'btdv', 'experts', 'tokens'):
        assert getattr(ctx, hook)(x) is x
    assert treg.tp_of(None, cfg) == 1
    with pytest.raises(NotImplementedError, match='mesh'):
        treg.tp_of(object(), cfg)


def test_spec_to_placements_follows_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES['pod2']
    assert tsh.spec_to_placements(P(('pod', 'data'), None, 'model'), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tsh.spec_to_placements(P(), m) == [Replicate()] * 3
    assert tsh.spec_to_sharding(None, {'a': P('data')}) == {'a': None}
    assert tsh.spec_to_sharding(m, {'a': [P('model')]}) == \
        {'a': [[Replicate(), Replicate(), Shard(0)]]}
    with pytest.raises(ValueError, match='order'):
        tsh.spec_to_placements(P(('model', 'data')), m)


def test_make_production_mesh_requires_ranks():
    """Without a process group of 256 ranks the production mesh refuses
    to build, as JAX's does on one device."""
    with pytest.raises(RuntimeError):
        jmesh.make_production_mesh()
    for kw in ({}, {'multi_pod': True}):
        with pytest.raises(RuntimeError, match='ranks'):
            tmesh.make_production_mesh(device='cpu', **kw)
    with pytest.raises(RuntimeError, match='ranks'):
        tmesh.make_test_mesh(device='cpu')


# --- the registry's specs ----------------------------------------------------

def _port_vs_jax_params(arch: str, tp: int):
    jcfg, cfg = jget(arch), tget(arch)
    jp = jax_leaves(jreg.abstract_params(jcfg, tp=tp))
    model = treg.abstract_params(cfg, tp=tp)
    return jcfg, cfg, jp, model


def _jax_key(name: str) -> tuple:
    """(the JAX leaf's key, the number of stacked layer dims) of a port
    parameter name."""
    parts = name.split('.')
    return ('.'.join(p for p in parts if not p.isdigit()),
            sum(p.isdigit() for p in parts))


@pytest.mark.parametrize('mesh', sorted(MESHES))
@pytest.mark.parametrize('arch', ALL_LM_ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    m = MESHES[mesh]
    jcfg, cfg, jp, model = _port_vs_jax_params(arch, 16)
    jspecs = jax_leaves(jreg.param_specs(jcfg, jreg.abstract_params(
        jcfg, tp=16), m), is_leaf=_is_jspec)
    specs = treg.param_specs(cfg, model, m)
    named = dict(model.named_parameters())
    assert specs.keys() == named.keys()
    covered = set()
    for name, spec in specs.items():
        key, stacked = _jax_key(name)
        want = tuple(jspecs[key])
        assert want[:stacked] == (None,) * len(want[:stacked]), (name, want)
        assert isinstance(spec, P)
        assert tuple(spec) == want[stacked:], (name, spec, want)
        for i, entry in enumerate(spec):
            if entry is not None:
                assert named[name].shape[i] % tsh.axes_size(m, entry) == 0
        covered.add(key)
    assert covered == set(jspecs)


@pytest.mark.parametrize('tp', [1, 16])
@pytest.mark.parametrize('arch', ALL_LM_ARCHS)
def test_abstract_params_shapes_equal_jax_on_meta(arch, tp):
    _, _, jp, model = _port_vs_jax_params(arch, tp)
    for name, p in model.named_parameters():
        assert p.device.type == 'meta'
        key, stacked = _jax_key(name)
        assert tuple(jp[key].shape[stacked:]) == tuple(p.shape), name
        assert str(jp[key].dtype) == str(p.dtype).removeprefix('torch.'), name
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jp.values())


def _state_pair(arch: str, batch: int, max_seq: int, tp: int):
    jcfg, cfg = jget(arch), tget(arch)
    jstate = jreg.abstract_decode_state(jcfg, batch, max_seq, tp)
    state = treg.init_decode_state(cfg, batch, max_seq, tp, device='meta')
    return jcfg, cfg, jstate, state


@pytest.mark.parametrize('long_context', [False, True])
@pytest.mark.parametrize('family', sorted(FAMILY_ARCHS))
def test_decode_state_and_batch_specs_equal_jax(family, long_context):
    arch = FAMILY_ARCHS[family]
    batch = 1 if long_context else 32
    for mesh in MESHES.values():
        jcfg, cfg, jstate, state = _state_pair(arch, batch, 256, 16)
        want = jax_leaves(jreg.decode_state_specs(
            jcfg, jstate, mesh, long_context=long_context), is_leaf=_is_jspec)
        got = jax_leaves(treg.decode_state_specs(
            cfg, state, mesh, long_context=long_context),
            is_leaf=lambda x: isinstance(x, P))
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])
        for seq in (1, 64):
            shapes = {'tokens': (batch, seq), 'labels': (batch, seq)}
            if family == 'encdec':
                shapes['frames'] = (batch, seq, cfg.d_model)
            jb = {k: jax.ShapeDtypeStruct(s, np.int32)
                  for k, s in shapes.items()}
            tb = {k: torch.empty(s, device='meta') for k, s in shapes.items()}
            want = jreg.batch_shardings(jcfg, mesh, jb)
            got = treg.batch_shardings(cfg, mesh, tb)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
    free = treg.decode_state_specs(cfg, state, None, long_context=False)
    assert set(jax_leaves(free, is_leaf=lambda x: isinstance(x, P))
               .values()) == {P()}


def test_batch_shardings_decode_token():
    tok = torch.empty((1, 1), dtype=torch.int32, device='meta')
    assert treg.batch_shardings(tget('yi-34b'), MESH, tok) == P()


# --- elastic plans -----------------------------------------------------------

def _plan(mod, *a, **kw):
    try:
        return mod.plan_remesh(*a, **kw)
    except ValueError as e:
        return ('ValueError', str(e))


@settings(max_examples=120, deadline=None)
@given(st.integers(1, 32).map(lambda x: 16 * x), st.integers(0, 200),
       st.sampled_from([1, 2, 4, 16]))
def test_plan_remesh_equals_jax(total, failed, model):
    got = _plan(tel, total, failed, model=model)
    want = _plan(jel, total, failed, model=model)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert (got.axes, got.shape, got.devices_used, got.grad_accum_factor,
                got.dropped_devices) == \
            (want.axes, want.shape, want.devices_used,
             want.grad_accum_factor, want.dropped_devices)


def test_plan_remesh_grid_and_runner_equal_jax():
    for total in range(16, 16 * 33, 16):
        for failed in range(0, 201, 7):
            a, b = _plan(tel, total, failed), _plan(jel, total, failed)
            assert (a == b if isinstance(b, tuple)
                    else tuple(vars(a).values()) == tuple(vars(b).values()))
    r, jr = tel.ElasticRunner(256, 16), jel.ElasticRunner(256, 16)
    for op, ids in (('step_failure', [3, 7]), ('step_failure', [7, 9, 11]),
                    ('step_recovery', [3]), ('step_recovery', [7, 9, 11])):
        got, want = getattr(r, op)(ids), getattr(jr, op)(ids)
        assert tuple(vars(got).values()) == tuple(vars(want).values())
    assert got.shape == (16, 16)
