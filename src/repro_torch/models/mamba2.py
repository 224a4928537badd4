"""Mamba2 (SSD) layer, used inside the Zamba2 hybrid.

State-space duality: the Mamba2 recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T ;   y_t = h_t C_t + D x_t

is decayed linear attention with q=C_t, k=B_t, v=dt_t*x_t and per-head
scalar log-decay dt_t*A, so the forward pass uses the chunkwise core of
``linear_scan`` and decode its O(1) recurrent step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _split_proj(u, cfg):
    di, _, _, ds = _dims(cfg)
    return u[..., :di], u[..., di:2 * di + 2 * ds], u[..., 2 * di + 2 * ds:]


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


def _ssm_inputs(p, x, cfg, conv_cache=None):
    """The SSD operands of x [B, S, D]: q, k, v, log_a, the gate z, the skip
    term and the new conv cache.  ``dt`` is softplus'd in float32; v is
    rounded to the model dtype after the ``dt`` product."""
    di, h, hd, ds = _dims(cfg)
    z, xbc, dt = _split_proj(x @ p['w_in'], cfg)
    xbc, new_conv = _causal_conv(xbc, p['conv'], conv_cache)
    xs = xbc[..., :di]
    b_in = xbc[..., di:di + ds]
    c_in = xbc[..., di + ds:]
    dt = F.softplus(dt.float() + p['dt_bias'])                  # [B, S, H]
    log_a = -torch.exp(p['a_log'])[None, None, :] * dt          # <= 0
    bsz, s = x.shape[:2]
    xh = xs.reshape(bsz, s, h, hd)
    v = (xh.float() * dt[..., None]).to(x.dtype)
    q = c_in[:, :, None, :].expand(bsz, s, h, ds)
    k = b_in[:, :, None, :].expand(bsz, s, h, ds)
    d_skip = (xh * p['d_skip'][None, None, :, None]).to(x.dtype)
    return q, k, v, log_a, z, d_skip, new_conv


def _out(p, res, y, z, cfg):
    y = L.rmsnorm(y, p['out_norm'], cfg.norm_eps)
    y = y.reshape(res.shape[0], res.shape[1], -1) * F.silu(z)
    return res + y @ p['w_out']


def mamba_block(p, x, cfg):
    """A residual Mamba2 layer over x [B, S, D] (chunkwise form)."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, log_a, z, d_skip, _ = _ssm_inputs(p, xx, cfg)
    y, _ = chunked_linear_attention(q, k, v, log_a)
    return _out(p, x, y + d_skip, z, cfg)


def init_state(cfg, batch: int, *, device) -> dict:
    """One layer's decode state: ``ssm`` [B, H, ds, hd] float32 and
    ``conv`` [B, K-1, C] in the model dtype, zeroed."""
    di, h, hd, ds = _dims(cfg)
    return {'ssm': torch.zeros((batch, h, ds, hd), dtype=torch.float32,
                               device=device),
            'conv': torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ds),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def mamba_decode(p, x, state, cfg):
    """x [B, 1, D]: the O(1) recurrent step.  Returns (y [B, 1, D], new
    state)."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, log_a, z, d_skip, new_conv = _ssm_inputs(
        p, xx, cfg, conv_cache=state['conv'])
    y, ssm = linear_attention_step(state['ssm'], q[:, 0], k[:, 0], v[:, 0],
                                   log_a[:, 0])
    return _out(p, x, y[:, None] + d_skip, z, cfg), {'ssm': ssm,
                                                    'conv': new_conv}
