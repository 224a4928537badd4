"""Mamba2 (SSD) layer, used inside the Zamba2 hybrid.

State-space duality: the Mamba2 recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T ;   y_t = h_t C_t + D x_t

is decayed linear attention with q=C_t, k=B_t, v=dt_t*x_t and per-head
scalar log-decay dt_t*A, so the forward pass uses the chunkwise core of
``linear_scan`` and decode its O(1) recurrent step.

Partitioned (DTensor inputs, recipe ``ssm``): the JAX package constrains
only the residual (``btd``); inside, the port lays the layer out by heads
over ``model`` (a ``model`` that does not divide them raises).  ``w_in``'s
columns ``[z | x, B, C | dt]`` are split over ``model`` at offsets that
fall inside the parts (at production size 524 of 8,384 a rank), so its
output is gathered whole once; then each rank takes its heads' z, x and
dt channels and all of B and C, and runs the depthwise conv on those
channels, the SSD core on its heads and the per-head ``out_norm``
locally (``_mixer`` under ``local_map``); its gated output is a block of
``w_out``'s rows (``merge``).  In decode the conv
window (JAX's layout: channels over ``model``) is gathered for the step
and each rank writes back its block; the SSD state is split by heads, as
the layer, so its step is local.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime import spmd
from ..runtime.sharding import (ShardCtx, local_range, mesh_axes,
                                unshard_dims)
from . import layers as L
from .linear_scan import chunked_linear_attention, linear_attention_step

EXPAND = 2


def _dims(cfg):
    d_inner = EXPAND * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba_params(gen: torch.Generator, cfg, dtype) -> dict:
    """One layer's weights; ``a_log``, ``dt_bias`` and ``d_skip`` are
    float32 whatever ``dtype`` is."""
    d = cfg.d_model
    di, h, hd, ds = _dims(cfg)
    dev = gen.device
    return {
        'ln': torch.ones((d,), dtype=dtype, device=dev),
        # fused in-projection: [z (gate), x, B, C, dt]
        'w_in': L.dense_init(gen, d, 2 * di + 2 * ds + h, dtype),
        'conv': L.normal(gen, (cfg.ssm_conv, di + 2 * ds), dtype, 0.1),
        'a_log': torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        'dt_bias': torch.zeros((h,), dtype=torch.float32, device=dev),
        'd_skip': torch.ones((h,), dtype=torch.float32, device=dev),
        'out_norm': torch.ones((hd,), dtype=dtype, device=dev),
        'w_out': L.dense_init(gen, di, d, dtype,
                              scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _causal_conv(xbc, conv_w, cache=None):
    """Depthwise causal conv over time, then SiLU.  xbc [B, S, C]; conv_w
    [K, C].  With ``cache`` [B, K-1, C] given (decode, S = 1), returns (out
    [B, 1, C], new cache), else (out, None)."""
    kk = conv_w.shape[0]
    if cache is None:
        s = xbc.shape[1]
        pad = F.pad(xbc, (0, 0, kk - 1, 0))
        out = sum(pad[:, i:i + s] * conv_w[i] for i in range(kk))
        return F.silu(out), None
    window = torch.cat([cache, xbc], dim=1)                  # [B, K, C]
    out = torch.einsum('bkc,kc->bc', window, conv_w)[:, None]
    return F.silu(out), window[:, 1:]


def _operands(u, p, cfg, heads: tuple, conv_cache=None):
    """The SSD operands of heads ``[lo, hi)`` from the in-projection u [B,
    S, 2 di + 2 ds + h] (``[z | x, B, C | dt]``): q, k, v, log_a, the gate
    z, the skip term and the new conv cache of their conv channels (their
    x, then B and C) from ``conv_cache`` [B, K-1, di + 2 ds] (every
    channel).  ``dt`` is softplus'd in float32; v is rounded to the model
    dtype after the ``dt`` product."""
    di, _, hd, ds = _dims(cfg)
    lo, hi = heads
    n = hi - lo

    def chans(t):       # of conv channels [x | B, C]: the heads' x, B, C
        return torch.cat([t[..., lo * hd:hi * hd], t[..., di:di + 2 * ds]],
                         dim=-1)

    xbc, new_conv = _causal_conv(
        chans(u[..., di:2 * di + 2 * ds]), chans(p['conv']),
        None if conv_cache is None else chans(conv_cache))
    xs = xbc[..., :n * hd]
    b_in = xbc[..., n * hd:n * hd + ds]
    c_in = xbc[..., n * hd + ds:]
    dt = F.softplus(u[..., 2 * di + 2 * ds + lo:2 * di + 2 * ds + hi].float()
                    + p['dt_bias'][lo:hi])                    # [B, S, n]
    log_a = -torch.exp(p['a_log'][lo:hi])[None, None, :] * dt  # <= 0
    bsz, s = u.shape[:2]
    xh = xs.reshape(bsz, s, n, hd)
    v = (xh.float() * dt[..., None]).to(u.dtype)
    q = c_in[:, :, None, :].expand(bsz, s, n, ds)
    k = b_in[:, :, None, :].expand(bsz, s, n, ds)
    d_skip = (xh * p['d_skip'][lo:hi][None, None, :, None]).to(u.dtype)
    return q, k, v, log_a, u[..., lo * hd:hi * hd], d_skip, new_conv


def _ssm_inputs(p, x, cfg, conv_cache=None):
    """The SSD operands of x [B, S, D] over every head (``_operands``)."""
    return _operands(x @ p['w_in'], p, cfg, (0, _dims(cfg)[1]), conv_cache)


def _mixer(u, p, cfg, heads: tuple, conv_cache=None, ssm=None):
    """Heads ``[lo, hi)`` of the layer from its in-projection u: the gated
    output [B, S, (hi - lo) hd] (before ``w_out``), their new SSD state
    (decode: ``ssm`` [B, hi - lo, ds, hd] given, S = 1; else None) and the
    new conv cache of their channels."""
    q, k, v, log_a, z, d_skip, new_conv = _operands(u, p, cfg, heads,
                                                    conv_cache)
    if ssm is None:
        y, _ = chunked_linear_attention(q, k, v, log_a)
    else:
        y, ssm = linear_attention_step(ssm, q[:, 0], k[:, 0], v[:, 0],
                                       log_a[:, 0])
        y = y[:, None]
    y = L.rmsnorm(y + d_skip, p['out_norm'], cfg.norm_eps)
    return y.reshape(u.shape[0], u.shape[1], -1) * F.silu(z), ssm, new_conv


_MIXER_WEIGHTS = ('conv', 'a_log', 'dt_bias', 'd_skip', 'out_norm')


def _heads(cfg, mesh) -> tuple:
    """This rank's heads ``[lo, hi)``: ``model`` splits them.  Raises
    where it does not divide them (every rank would run them all)."""
    h = _dims(cfg)[1]
    tp = mesh_axes(mesh).get('model', 1)
    if h % tp:
        raise ValueError(f'{cfg.name}: model={tp} does not divide the '
                         f'{h} Mamba2 heads')
    r = spmd.coord(mesh, 'model') if tp > 1 else 0
    return r * (h // tp), (r + 1) * (h // tp)


def _mix(p, xx, cfg, conv_cache=None, ssm=None):
    """The layer between its norm and ``w_out`` on xx [B, S, D]: (the
    gated output [B, S, di], the new SSD state, the new conv cache), the
    states in decode only.  On DTensors, ``w_in``'s output gathered whole
    and ``_mixer`` on each rank's heads (``local_map``): the output comes
    out with di over ``model``, the SSD state in its own layout (raises
    where it does not split the heads as the layer does), the conv cache
    whole over ``model``.  The gradients are
    declared: pending sums for u and the mixer's weights over the ranks
    that split the heads, for the weights also over those that split the
    rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    u = L.project(xx, p['w_in'])[0]
    if not isinstance(u, DTensor):
        return _mixer(u, p, cfg, (0, _dims(cfg)[1]), conv_cache, ssm)
    from torch.distributed.tensor.experimental import local_map
    di, _, _, ds = _dims(cfg)
    # whole: w_in's split points do not fall on the parts' boundaries
    u = unshard_dims(u, (1, 2))
    mesh = u.device_mesh
    lo, hi = _heads(cfg, mesh)
    tp_dim = [a == 'model' and n > 1 for a, n in mesh_axes(mesh).items()]
    whole = [Replicate()] * mesh.ndim
    ws = [p[n].redistribute(mesh, whole) for n in _MIXER_WEIGHTS]
    rows = list(u.placements)
    y_pl = [Shard(2) if t else q for t, q in zip(tp_dim, rows)]
    u_grad = [Partial() if t else q for t, q in zip(tp_dim, rows)]
    w_grad = [Partial() if t or q.is_shard() else q
              for t, q in zip(tp_dim, rows)]
    new_conv = None
    if ssm is not None:
        if (tuple(local_range(ssm, 1)) != (lo, hi)
                or any(q.is_shard() and q.dim > 1 for q in ssm.placements)):
            raise ValueError(f'{cfg.name}: the SSD state is laid out '
                             f'{tuple(ssm.placements)}; the partitioned '
                             'step needs its heads split as the layer '
                             f'splits them (heads {lo}..{hi} here)')
        conv_cache = unshard_dims(conv_cache, (1, 2))
        new_conv = torch.cat([conv_cache, u[..., di:2 * di + 2 * ds]],
                             dim=1)[:, 1:]

    def body(u, *rest):
        wd = dict(zip(_MIXER_WEIGHTS, rest))
        y, s, _ = _mixer(u, wd, cfg, (lo, hi), *rest[len(ws):])
        return y if s is None else (y, s)

    states = () if ssm is None else (conv_cache, ssm)
    out_pl = y_pl if ssm is None else (y_pl, list(ssm.placements))
    out = local_map(body, out_placements=out_pl,
                    in_placements=(rows, *(whole,) * len(ws),
                                   *(list(t.placements) for t in states)),
                    in_grad_placements=(u_grad, *(w_grad,) * len(ws),
                                        *(list(t.placements)
                                          for t in states)),
                    device_mesh=mesh)(u, *ws, *states)
    y, ssm = (out, None) if ssm is None else out
    return y, ssm, new_conv


def mamba_block(p, x, cfg, ctx: ShardCtx = L.NO_CTX):
    """A residual Mamba2 layer over x [B, S, D] (chunkwise form)."""
    y, _, _ = _mix(p, L.rmsnorm(x, p['ln'], cfg.norm_eps), cfg)
    return ctx.btd(x + ctx.btd(L.merge(y, p['w_out'])))


def init_state(cfg, batch: int, *, device) -> dict:
    """One layer's decode state: ``ssm`` [B, H, ds, hd] float32 and
    ``conv`` [B, K-1, C] in the model dtype, zeroed."""
    di, h, hd, ds = _dims(cfg)
    return {'ssm': torch.zeros((batch, h, ds, hd), dtype=torch.float32,
                               device=device),
            'conv': torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ds),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def mamba_decode(p, x, state, cfg, ctx: ShardCtx = L.NO_CTX):
    """x [B, 1, D]: the O(1) recurrent step.  Returns (y [B, 1, D], new
    state)."""
    y, ssm, conv = _mix(p, L.rmsnorm(x, p['ln'], cfg.norm_eps), cfg,
                        state['conv'], state['ssm'])
    return ctx.btd(x + ctx.btd(L.merge(y, p['w_out']))), {'ssm': ssm,
                                                          'conv': conv}
