"""Chunkwise-parallel gated linear attention: the shared core of xLSTM's
mLSTM and Mamba2's SSD (both are decayed linear attention).

Recurrence (per head, per step):
    S_t = a_t * S_{t-1} + k_t v_t^T          # state [dk, dv]
    y_t = q_t^T S_t                           # output [dv]

Chunkwise form (chunk width W): within a chunk, cumulative log-decays make
the intra-chunk term a masked (W x W) product and the inter-chunk term a
rank-dk update:

    F_t   = sum_{j<=t} log a_j                           (in-chunk cumsum)
    intra = ((Q K^T) * exp(F_t - F_s) * [s<=t]) V
    inter = exp(F_t) * (Q @ S_prev)
    S_new = exp(F_W) * S_prev + sum_s exp(F_W - F_s) k_s v_s^T

Gates satisfy log a <= 0, so every exponent above is bounded.  All of it is
float32, whatever the input dtype; the outputs are cast back to q's.

``normalize=True`` appends a ones-column to V so the same recurrence
carries the mLSTM normalizer n_t; outputs are divided by max(|n^T q|, 1).
"""
from __future__ import annotations

import torch

from .layers import NEG_INF


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _normalized(y: torch.Tensor, dv: int) -> torch.Tensor:
    out, n_q = y[..., :dv], y[..., dv]
    return out / torch.clamp(n_q.abs(), min=1.0)[..., None]


def chunked_linear_attention(q, k, v, log_a, *, chunk: int = 512,
                             normalize: bool = False, state_in=None):
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_a: [B, S, H] (<= 0).

    Returns (y [B, S, H, dv], final state [B, H, dk, dv(+1)]).  The chunk
    width is the largest at most ``chunk`` that divides S.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if normalize:
        v = _with_ones(v)
    w = min(chunk, s)
    while s % w:
        w -= 1
    state = state_in if state_in is not None else torch.zeros(
        (b, h, dk, v.shape[-1]), dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(s // w):
        qc, kc, vc = (x[:, c * w:(c + 1) * w].float() for x in (q, k, v))
        f = torch.cumsum(log_a[:, c * w:(c + 1) * w].float(), dim=1)  # [B,w,H]
        f_tot = f[:, -1]                                              # [B,H]
        qk = torch.einsum('bthd,bshd->bhts', qc, kc)                  # [B,H,w,w]
        fh = f.permute(0, 2, 1)                                       # [B,H,w]
        decay = fh[:, :, :, None] - fh[:, :, None, :]                 # [B,H,t,s]
        # mask before exp: the upper triangle's exponents are positive
        gate = torch.exp(torch.where(tri, decay, NEG_INF))
        intra = torch.einsum('bhts,bshv->bthv', qk * gate, vc)
        qs = qc * torch.exp(f)[..., None]
        inter = torch.einsum('bthd,bhdv->bthv', qs, state)
        ys.append(intra + inter)
        kd = kc * torch.exp(f_tot[:, None] - f)[..., None]
        outer = torch.einsum('bshd,bshv->bhdv', kd, vc)
        state = state * torch.exp(f_tot)[..., None, None] + outer
    y = torch.cat(ys, dim=1)
    if normalize:
        y = _normalized(y, dv)
    return y.to(q.dtype), state


def linear_attention_step(state, q, k, v, log_a, *, normalize: bool = False):
    """Single-token recurrent step (decode).  q, k: [B, H, dk]; v: [B, H,
    dv]; log_a: [B, H]; state [B, H, dk, dv(+1)].  Returns (y [B, H, dv],
    new state)."""
    dv = v.shape[-1]
    if normalize:
        v = _with_ones(v)
    a = torch.exp(log_a.float())[..., None, None]
    outer = torch.einsum('bhd,bhv->bhdv', k.float(), v.float())
    state = state * a + outer
    y = torch.einsum('bhd,bhdv->bhv', q.float(), state)
    if normalize:
        y = _normalized(y, dv)
    return y.to(q.dtype), state
