"""What a train step keeps live, against the plain forms it replaces, on
the CPU.

``adam.step`` updates each tensor in row slices of at most
``adam.SLICE_BYTES`` of float32, the moments in place: over three steps it
is bit for bit a plain mirror of the whole-tensor update (kept here), for
float32 and bfloat16 parameters and moments, clipping and weight decay on
and off, a tensor ``lr_scale``, a tensor above the cap, one of odd shape
and a 0-d one; on ``meta`` its update holds about two slices of float32
above its inputs; and it agrees with the JAX package's ``adam.step``.

xlstm's mLSTM block is bit for bit the old block (a mirror kept in
``torch_peak_ranks.py``), forward and every gradient, plainly and on 4
gloo ranks (data 2, model 2).  On the dry run's layout (a ``fake`` group
of 256 ranks, data 16 x model 16, ``meta`` tensors) it keeps for the
backward one gated k where the old block also kept k / sqrt(hd) (the gate
product saves k's block and recomputes the scale), no out-norm scale
whole over ``model``, and the rank's blocks of the operands that it
gathers whole over ``model`` in place of the gathered values.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import schedule as jsched

from repro_torch.analysis import op_count
from repro_torch.configs import get_config
from repro_torch.models import xlstm
from repro_torch.models.linear_scan import chunked_linear_attention
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched
from torch_peak_ranks import CHUNK, block_rank, old_block
from torch_serve_parity import one_torch_thread  # noqa: F401


# -- adam.step ---------------------------------------------------------------

def _mirror_step(params, grads, state, cfg, lr_scale):
    """The whole-tensor update that ``adam.step`` replaced, on plain
    tensors: new (params, mu, nu), the inputs left as they were."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads))
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    cf = (state.step + 1).float()
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)
    lr = cfg.lr * lr_scale
    out = ([], [], [])
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.float()
        out[0].append((p.float() - lr * update).to(p.dtype))
        out[1].append(m32.to(m.dtype))
        out[2].append(v32.to(v.dtype))
    return out, gnorm


SHAPES = ((7, 5), (3, 5, 40), (), (16,), (33, 2, 3))


def _tensors(shapes, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.tensor((rng.standard_normal(s) * scale).astype(np.float32)
                         ).to(dtype) for s in shapes]


def _check_steps(shapes, p_dtype, s_dtype, clip, wd):
    cfg = tadam.AdamConfig(lr=1e-2, weight_decay=wd, clip_norm=clip,
                           state_dtype=s_dtype)
    params = _tensors(shapes, p_dtype, 0, 0.1)
    want_p = [p.clone() for p in params]
    state = tadam.init(params, cfg)
    want_m = [m.clone() for m in state.mu]
    want_v = [v.clone() for v in state.nu]
    for i in range(3):
        grads = _tensors(shapes, p_dtype, 10 + i)
        lr_scale = tsched.linear_warmup_cosine(state.step, warmup_steps=1,
                                               total_steps=6)
        mirror_state = tadam.AdamState(state.step, want_m, want_v)
        (want_p, want_m, want_v), want_norm = _mirror_step(
            want_p, grads, mirror_state, cfg, lr_scale)
        params, state, gnorm = tadam.step(params, grads, state, cfg,
                                          lr_scale)
        assert torch.equal(gnorm, want_norm)
        for got, want in zip((*params, *state.mu, *state.nu),
                             (*want_p, *want_m, *want_v)):
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(state.step) == 3


@pytest.mark.parametrize('wd', (0.0, 0.01))
@pytest.mark.parametrize('clip', (None, 1.0))
@pytest.mark.parametrize('s_dtype', (torch.float32, torch.bfloat16))
@pytest.mark.parametrize('p_dtype', (torch.float32, torch.bfloat16))
def test_sliced_adam_is_the_whole_tensor_update(monkeypatch, p_dtype,
                                                s_dtype, clip, wd):
    """With the cap at 96 bytes every tensor but the 0-d one and the
    16-vector is cut: (7, 5) in rows of 4, (3, 5, 40) into 30 slices of
    24 and 16 elements (its rows, and their rows, are above the cap),
    (33, 2, 3) in rows of 4 with a last slice of one row."""
    monkeypatch.setattr(tadam, 'SLICE_BYTES', 96)
    cut = list(tadam._slices(torch.Size((3, 5, 40)), 96))
    assert len(cut) == 30 and cut[-1] == (2, 4, slice(24, 48))
    _check_steps(SHAPES, p_dtype, s_dtype, clip, wd)


def test_sliced_adam_at_the_real_cap():
    """A bfloat16 tensor of 4,097 x 4,096 is just above the 64 MiB cap of
    float32: two slices, bit for bit the whole-tensor update."""
    shape = torch.Size((4097, 4096))
    assert [s[0] for s in tadam._slices(shape, tadam.SLICE_BYTES)] == [
        slice(0, 4096), slice(4096, 8192)]
    _check_steps((tuple(shape), (5,)), torch.bfloat16, torch.float32, 1.0,
                 0.01)


def _peak_above_inputs(p_dtype, s_dtype, monkeypatch=None):
    shape = (49152, 960)                  # smollm-360m's tied embedding
    cfg = tadam.AdamConfig(weight_decay=0.01, state_dtype=s_dtype)
    p = torch.empty(shape, dtype=p_dtype, device='meta')
    g = torch.empty_like(p)
    state = tadam.init([p], cfg)
    return op_count.analyze(tadam.step, [p], [g], state, cfg,
                            torch.ones((), device='meta'))['peak_bytes']


def test_sliced_adam_holds_two_slices_of_float32(monkeypatch):
    """On ``meta``, for smollm's [49152, 960] embedding (189 MB in
    float32, three slices): the update adds at most two float32 slices
    and a bfloat16 half slice above its inputs (the whole-tensor update
    held seven float32 copies of the tensor).  The global norm is counted
    apart: its sum of squares runs whole, so that it rounds as before, on
    one float32 copy of a bfloat16 gradient."""
    slice_f32 = 17476 * 960 * 4                  # the rows of one slice
    whole_f32 = 49152 * 960 * 4
    assert 2 * slice_f32 <= 2 * tadam.SLICE_BYTES
    assert _peak_above_inputs(torch.bfloat16, torch.float32) <= whole_f32 + 64
    monkeypatch.setattr(tadam, 'global_norm',
                        lambda gs: torch.ones((), device='meta'))
    for p_dtype in (torch.bfloat16, torch.float32):
        assert (_peak_above_inputs(p_dtype, torch.float32)
                <= 2 * slice_f32 + slice_f32 // 2 + 64)


@pytest.mark.parametrize('dtype', ('float32', 'bfloat16'))
def test_sliced_adam_matches_jax(monkeypatch, dtype):
    """Three steps on the same numpy inputs as ``repro.optim.adam.step``,
    the cap at 96 bytes so that each tensor is cut, at the tolerances of
    ``test_torch_lm_optim.py::test_adam_lr_scale_matches_jax``."""
    import jax.numpy as jnp
    monkeypatch.setattr(tadam, 'SLICE_BYTES', 96)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == 'bfloat16'
                else (jnp.float32, torch.float32))
    rng = np.random.default_rng(5)
    p = {'a': rng.standard_normal((9, 7)).astype(np.float32) * 0.1,
         'b': rng.standard_normal((40,)).astype(np.float32) * 0.1}
    g = {k: rng.standard_normal(x.shape).astype(np.float32)
         for k, x in p.items()}
    jcfg = jadam.AdamConfig(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    tcfg = tadam.AdamConfig(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    jp = {k: jnp.asarray(x, jdt) for k, x in p.items()}
    jg = {k: jnp.asarray(x, jdt) for k, x in g.items()}
    tp = [torch.tensor(p[k]).to(tdt) for k in ('a', 'b')]
    tg = [torch.tensor(g[k]).to(tdt) for k in ('a', 'b')]
    jstate, tstate = jadam.init(jp, jcfg), tadam.init(tp, tcfg)
    kw = dict(warmup_steps=2, total_steps=6)
    for _ in range(3):
        jscale = jsched.linear_warmup_cosine(jstate.step, **kw)
        tscale = tsched.linear_warmup_cosine(tstate.step, **kw)
        jp, jstate, jnorm = jadam.step(jp, jg, jstate, jcfg, lr_scale=jscale)
        tp, tstate, tnorm = tadam.step(tp, tg, tstate, tcfg, lr_scale=tscale)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        for i, k in enumerate(('a', 'b')):
            np.testing.assert_allclose(tp[i].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=1e-5, atol=1e-7)
            for got, want in ((tstate.mu[i], jstate.mu[k]),
                              (tstate.nu[i], jstate.nu[k])):
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           rtol=1e-5, atol=1e-12)


# -- the mLSTM block -----------------------------------------------------------

SMALL = dict(d_model=64, n_heads=4, n_layers=8)     # hd 32, di 128


@pytest.fixture
def small_chunks(monkeypatch):
    """The scan in chunks of 16, so that its chunks are checkpointed."""
    scan = functools.partial(chunked_linear_attention, chunk=CHUNK)
    monkeypatch.setattr(xlstm, 'chunked_linear_attention', scan)
    return scan


def _small_block(dtype):
    cfg = dataclasses.replace(get_config('xlstm-1.3b'), **SMALL)
    p = xlstm.mlstm_params(torch.Generator().manual_seed(0), cfg, dtype)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 64, 64)).astype(np.float32)
                     ).to(dtype)
    cot = torch.tensor(rng.standard_normal((2, 64, 64)).astype(np.float32)
                       ).to(dtype)
    return cfg, p, x, cot


@pytest.mark.parametrize('dtype', (torch.bfloat16, torch.float32))
def test_mlstm_block_is_theold_block_bit_for_bit(small_chunks, dtype):
    """Forward and the gradients of x and of every weight, for a seeded
    cotangent, equal the old block's bit for bit."""
    cfg, p, x, cot = _small_block(dtype)
    leaves = [x, *p.values()]
    outs = {}
    for name, fn in (('old', functools.partial(old_block,
                                               scan=small_chunks)),
                     ('new', xlstm.mlstm_block)):
        args = [t.detach().clone().requires_grad_() for t in leaves]
        y = fn(dict(zip(p, args[1:])), args[0], cfg)
        outs[name] = (y, torch.autograd.grad(y, args, cot))
    (y0, g0), (y1, g1) = outs['old'], outs['new']
    assert torch.equal(y0, y1)
    for name, a, b in zip(('x', *p), g0, g1):
        assert torch.equal(a, b), name


def _saved(fn, *args) -> list:
    """(bytes, local shape) of each storage that autograd saves during
    ``fn(*args)``, once each; a DTensor's local block."""
    seen = {}

    def pack(t):
        local = t.to_local() if hasattr(t, 'placements') else t
        st = local.untyped_storage()
        seen.setdefault(st._cdata, (st.nbytes(), tuple(local.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return list(seen.values())


@pytest.fixture(scope='module')
def dry_run_block():
    """One mLSTM block of xlstm-1.3b at ``train_4k`` on the dry run's
    layout: a ``fake`` group of 256 ranks (data 16, model 16), ``meta``
    tensors, x a rank's [16, 256, 2048] block (batch over ``data``,
    sequence over ``model``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    dryrun.init_fake_world(256)
    try:
        mesh = dryrun.dry_run_mesh('single', 'partitioned')
        cfg = dataclasses.replace(get_config('xlstm-1.3b'), n_layers=8)
        ctx = registry.make_ctx(mesh, cfg)
        params, _, _ = registry.shard_step_inputs(
            cfg, mesh, registry.abstract_params(cfg, registry.tp_of(mesh,
                                                                    cfg)))
        p = ctx.weights(params.blocks[0].mlstm[0])
        x = DTensor.from_local(
            torch.empty((16, 256, 2048), dtype=torch.bfloat16,
                        device='meta'), mesh, [Shard(0), Shard(1)],
            run_check=False).requires_grad_()
        yield cfg, ctx, p, x
    finally:
        dist.destroy_process_group()


def test_mlstm_block_keeps_one_gated_k(dry_run_block):
    """Saved tensors of the whole heads' shape a rank, [16, 4096, 4,
    1024] (0.54 GB): the old block kept four (q and the gated k, which the
    scan keeps; k / √hd, which the gate product kept; the out-norm's scale
    whole over ``model``); the block keeps q and the gated k.  Its k
    is saved as the rank's [16, 4096, 4, 64] block."""
    cfg, ctx, p, x = dry_run_block
    heads = 16 * 4096 * 4096 * 2
    old = _saved(old_block, p, x, cfg, ctx)
    new = _saved(xlstm.mlstm_block, p, x, cfg, ctx)
    assert sum(n == heads and len(s) == 4 for n, s in old) == 4
    assert sum(n == heads and len(s) == 4 for n, s in new) == 2
    assert (16 * 4096 * 4 * 64 * 2, (16, 4096, 4, 64)) in new


def test_mlstm_block_saves_blocks_not_gathered_operands(dry_run_block):
    """The old block kept x gathered over the sequence [16, 4096, 2048]
    for ``w_up`` and ``w_gate`` and u whole [16, 4096, 4096] for the four
    projections after it; the block keeps neither, but their blocks
    [16, 256, 2048] and [16, 4096, 256], and saves 1.75 GB where the old
    saved 3.51."""
    cfg, ctx, p, x = dry_run_block
    old = _saved(old_block, p, x, cfg, ctx)
    new = _saved(xlstm.mlstm_block, p, x, cfg, ctx)
    gathered = {16 * 4096 * 2048 * 2, 16 * 4096 * 4096 * 2}
    flat = lambda saved: {(n, math.prod(s)) for n, s in saved}  # noqa
    for rows, width in ((4096, 2048), (4096, 4096)):
        assert (rows * width * 16 * 2, 16 * rows * width) in flat(old)
    assert not {n for n, s in new if len(s) != 4} & gathered
    shapes = {s for _, s in new}
    assert (16, 256, 2048) in shapes and (16, 4096, 256) in shapes
    assert sum(n for n, _ in new) < 0.5 * sum(n for n, _ in old)


def test_mlstm_block_on_a_mesh_is_the_old_block_bit_for_bit(tmp_path):
    """On 4 gloo ranks, (data 2, model 2), reduced xlstm-1.3b (3 heads of
    hd 64: hd over ``model``, as 4 heads on 16 ranks), chunks of 16: the
    block's output and the gradients of x and of every weight, laid out
    as ``registry.shard_step_inputs`` lays them, equal the old block's
    bit for bit (the regathered operands and the out-norm's laid-out
    weight change no sum)."""
    from torch_mesh_ranks import spawn
    got = spawn(block_rank, tmp_path)
    for rec in got:
        assert set(rec['old']) == set(rec['new'])
        for key, want in rec['old'].items():
            assert torch.equal(rec['new'][key], want), key
