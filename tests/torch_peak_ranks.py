"""The old mLSTM block, a mirror of the port's block before it saved the
blocks of its gathered operands (``tests/test_torch_peak_parity.py``), and
the function each rank of a 4-rank gloo group runs with it
(``torch_mesh_ranks.spawn``).  Imports no JAX."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import xlstm
from repro_torch.models.linear_scan import chunked_linear_attention
from repro_torch.runtime.sharding import reduce_partials, unshard_dims

CHUNK = 16         # the scan's chunk in the block tests: several a block


def _old_rmsnorm(x, w, eps):
    """``layers.rmsnorm`` before the weight took the layout of a sharded
    last axis."""
    x32 = x.float()
    if any(p.is_shard(x.ndim - 1) for p in getattr(x, 'placements', ())):
        var = reduce_partials(torch.sum(x32 * x32, dim=-1, keepdim=True)
                              ) / x.shape[-1]
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x * (torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _old_gates(k, gates):
    b, s, h, _ = k.shape
    gates = gates.reshape(b, s, 2, h).float()
    log_f = F.logsigmoid(gates[:, :, 0])
    i_gate = torch.sigmoid(gates[:, :, 1])
    return k * i_gate[..., None].to(k.dtype), log_f


def old_block(p, x, cfg, ctx=L.NO_CTX, scan=chunked_linear_attention):
    """The mLSTM block as it was: u and k gathered whole and kept, k / √hd
    kept by the gate product, the out-norm's scale whole over ``model``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    hd = 2 * cfg.d_model // h
    xx = _old_rmsnorm(x, p['ln'], cfg.norm_eps)
    u, g = L.project(xx, p['w_up'], p['w_gate'])
    u = unshard_dims(u, (1, 2))
    q = unshard_dims(L.project(u, p['wq'])[0], (2,)).reshape(b, s, h, hd)
    k = unshard_dims(L.project_heads(u, p['wk'], h, ctx), (3,)) / math.sqrt(
        hd)
    v = ctx.btdv(L.project_heads(u, p['wv'], h, ctx))
    k, log_f = L.on_rows(_old_gates, (k, L.project(u, p['w_if'])[0]),
                         n_out=2)
    y, _ = scan(q, k, v, log_f, normalize=True)
    y = unshard_dims(_old_rmsnorm(y, p['out_norm'], cfg.norm_eps), (-2, -1))
    y = y.reshape(b, s, -1)
    if hasattr(y, 'placements'):
        y = y.redistribute(g.device_mesh, g.placements)
    y = y * F.silu(g)
    return ctx.btd(x + ctx.btd(L.merge(y, p['w_down'])))



def block_rank(rank: int) -> dict:
    """One mLSTM block of reduced xlstm-1.3b on (data 2, model 2), the
    weights and x laid out as the train step lays them: the output and the
    gradients of x and of every weight (whole), through ``old_block`` and
    ``xlstm.mlstm_block``, for a seeded cotangent."""
    from torch.distributed.tensor import distribute_tensor, Shard
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import registry
    scan = functools.partial(chunked_linear_attention, chunk=CHUNK)
    xlstm.chunked_linear_attention = scan
    cfg = get_config('xlstm-1.3b').reduced(n_layers=4, d_model=96,
                                           n_heads=3, remat=True)
    mesh = make_test_mesh((2, 2), device='cpu')
    ctx = registry.make_ctx(mesh, cfg)
    model, _, _ = registry.shard_step_inputs(
        cfg, mesh, registry.init_params(0, cfg, device='cpu'))
    p = dict(model.blocks[0].mlstm[0].named_parameters())
    rng = np.random.default_rng(3)
    dtype = getattr(torch, cfg.dtype)
    x, cot = (distribute_tensor(torch.tensor(
        rng.standard_normal((4, 64, 96)).astype(np.float32)).to(dtype),
        mesh, [Shard(0), Shard(1)]) for _ in range(2))
    out = {}
    for name, fn in (('old', functools.partial(old_block, scan=scan)),
                     ('new', xlstm.mlstm_block)):
        leaves = [x.detach().requires_grad_(),
                  *(w.detach().requires_grad_() for w in p.values())]
        w = dict(zip(p.keys(), leaves[1:]))
        y = fn(ctx.weights(w), leaves[0], cfg, ctx)
        grads = torch.autograd.grad(y, leaves, cot)
        out[name] = {'y': y.full_tensor(),
                     **{k: g.full_tensor() for k, g in
                        zip(('x', *p.keys()), grads)}}
    return out
