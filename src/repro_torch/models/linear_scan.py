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

On DTensors (the partitioned program) both entry points run on each
rank's block (``local_map``), plain ops inside, so the chunk loop never
goes through DTensor's dispatch op by op.  ``chunked_linear_attention``
takes q, k and log_a whole over ``model`` (batch over the batch axes)
and v laid out by ``ShardCtx.btdv`` (dv over ``model``): every
contraction is then local.  ``linear_attention_step`` takes the layout
of the state it is given: its batch and heads split, the step is local;
its dk split (xlstm's 4 heads do not divide 16 ranks), ``q^T S`` and the
normalizer are partial sums, reduced across ranks before the division.
"""
from __future__ import annotations

import torch

from ..runtime.sharding import reduce_partials
from .layers import NEG_INF, remat


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _normalized(y: torch.Tensor, dv: int) -> torch.Tensor:
    out, n_q = y[..., :dv], y[..., dv]
    return out / torch.clamp(n_q.abs(), min=1.0)[..., None]


def _chunk_step(state, q, k, v, log_a, tri):
    """One chunk of ``chunked_linear_attention``: q, k [B, w, H, dk], v
    [B, w, H, dv(+1)] and log_a [B, w, H] in their own dtypes, the carried
    state [B, H, dk, dv(+1)] float32.  Returns (y [B, w, H, dv(+1)]
    float32, the next state)."""
    qc, kc, vc = q.float(), k.float(), v.float()
    f = torch.cumsum(log_a.float(), dim=1)                      # [B,w,H]
    f_tot = f[:, -1]                                            # [B,H]
    qk = torch.einsum('bthd,bshd->bhts', qc, kc)                # [B,H,w,w]
    fh = f.permute(0, 2, 1)                                     # [B,H,w]
    decay = fh[:, :, :, None] - fh[:, :, None, :]               # [B,H,t,s]
    # mask before exp: the upper triangle's exponents are positive
    gate = torch.exp(torch.where(tri, decay, NEG_INF))
    intra = torch.einsum('bhts,bshv->bthv', qk * gate, vc)
    qs = qc * torch.exp(f)[..., None]
    inter = torch.einsum('bthd,bhdv->bthv', qs, state)
    y = intra + inter
    kd = kc * torch.exp(f_tot[:, None] - f)[..., None]
    outer = torch.einsum('bshd,bshv->bhdv', kd, vc)
    return y, state * torch.exp(f_tot)[..., None, None] + outer


def chunked_linear_attention(q, k, v, log_a, *, chunk: int = 512,
                             normalize: bool = False, state_in=None):
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_a: [B, S, H] (<= 0).

    Returns (y [B, S, H, dv], final state [B, H, dk, dv(+1)]).  The chunk
    width is the largest at most ``chunk`` that divides S.  On DTensors
    (``_chunked_on_blocks``) returns (y, None): no caller reads the final
    state on a mesh, and with ``normalize`` a dv-split state would carry
    one normalizer column a rank.

    While grad is enabled each chunk runs under ``layers.remat`` (the
    JAX package's ``lax.scan(jax.checkpoint(step))``): the backward keeps
    the carried state a chunk and the chunks' inputs, and recomputes
    each chunk's float32 copies, scores, gates and products.  One chunk
    runs plain: checkpointed, it would differ in its saved bytes by that
    chunk's intermediates at most, which its backward recomputes at once,
    for one more forward.  The recompute replays the same operations on
    the same inputs, so the values and the gradients are those of the
    plain loop.
    """
    if hasattr(q, 'placements'):
        return _chunked_on_blocks(q, k, v, log_a, chunk, normalize), None
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if normalize:
        v = _with_ones(v)
    w = min(chunk, s)
    while s % w:
        w -= 1
    nc = s // w
    state = state_in if state_in is not None else torch.zeros(
        (b, h, dk, v.shape[-1]), dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        chunk_in = (x[:, c * w:(c + 1) * w] for x in (q, k, v, log_a))
        y_c, state = remat(nc > 1, _chunk_step, state, *chunk_in, tri)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    if normalize:
        y = _normalized(y, dv)
    return y.to(q.dtype), state


def _chunked_on_blocks(q, k, v, log_a, chunk: int, normalize: bool):
    """``chunked_linear_attention``'s y on each rank's blocks: q, k and
    log_a in one layout that splits only the batch and the heads, v in
    that layout or with its dv split where q is whole; y comes out as v.

    With ``normalize`` each rank appends its own ones column to its block
    of v, so its block of the state carries the normalizer n_t.  n
    depends only on k and the gates, which every rank holds whole, so each
    rank's n is the whole computation's, and its division of its own dv
    block by max(|n^T q|, 1) is the whole division's.  The gradients of q,
    k and log_a are declared pending sums over the ranks that split dv
    (each rank's dv block contributes its share); v's is its own block."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    qk_pl, v_pl = list(q.placements), list(v.placements)
    if (tuple(k.placements) != tuple(qk_pl)
            or tuple(log_a.placements) != tuple(qk_pl)
            or any(p.is_shard() and p.dim not in (0, 2) for p in qk_pl)
            or any(vp != qp and not (vp.is_shard(3) and qp == Replicate())
                   for vp, qp in zip(v_pl, qk_pl))):
        raise ValueError(
            'chunked_linear_attention on DTensors needs q, k and log_a in '
            'one layout of the batch and heads, and v in it or with dv '
            f'split where q is whole; got q {tuple(qk_pl)}, k '
            f'{tuple(k.placements)}, v {tuple(v_pl)}, log_a '
            f'{tuple(log_a.placements)}')
    grad = [Partial() if vp.is_shard(3) else qp
            for vp, qp in zip(v_pl, qk_pl)]

    def scan(q, k, v, log_a):
        return chunked_linear_attention(q, k, v, log_a, chunk=chunk,
                                        normalize=normalize)[0]

    return local_map(scan, out_placements=v_pl,
                     in_placements=(qk_pl, qk_pl, v_pl, qk_pl),
                     in_grad_placements=(grad, grad, v_pl, grad),
                     device_mesh=q.device_mesh)(q, k, v, log_a)


def _step(state, q, k, v, log_a, normalize: bool):
    """The recurrent update and the float32 read-out ``q^T S`` [B, H,
    dv(+1)], not yet normalized."""
    if normalize:
        v = _with_ones(v)
    a = torch.exp(log_a.float())[..., None, None]
    outer = torch.einsum('bhd,bhv->bhdv', k.float(), v.float())
    state = state * a + outer
    return torch.einsum('bhd,bhdv->bhv', q.float(), state), state


def _step_on_blocks(state, q, k, v, log_a, normalize: bool):
    """``_step`` on each rank's block of the DTensor ``state`` [B, H, dk,
    dv(+1)], q, k, v and log_a laid out to match it: where the state
    splits the batch or the heads the step is local; where it splits dk,
    v and log_a are whole, and the read-out is a pending sum, reduced
    here.  Raises on a state whose dv is split."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, s_pl = state.device_mesh, list(state.placements)
    if any(p.is_shard(3) or p.is_partial() for p in s_pl):
        raise ValueError('linear_attention_step on a DTensor state needs '
                         f'its dv whole, got {tuple(s_pl)}')
    whole = [Replicate() if p.is_shard(2) else p for p in s_pl]

    def laid(x, pl):
        return x if tuple(x.placements) == tuple(pl) else x.redistribute(
            mesh, pl)

    y, state = local_map(
        lambda s, q, k, v, a: _step(s, q, k, v, a, normalize),
        out_placements=([Partial() if p.is_shard(2) else p for p in s_pl],
                        s_pl),
        in_placements=(s_pl, s_pl, s_pl, whole, whole),
        device_mesh=mesh)(state, laid(q, s_pl), laid(k, s_pl),
                          laid(v, whole), laid(log_a, whole))
    return reduce_partials(y), state


def linear_attention_step(state, q, k, v, log_a, *, normalize: bool = False):
    """Single-token recurrent step (decode).  q, k: [B, H, dk]; v: [B, H,
    dv]; log_a: [B, H]; state [B, H, dk, dv(+1)].  Returns (y [B, H, dv],
    new state); on a DTensor state (``_step_on_blocks``) both laid out as
    the state, y whole where dk was split."""
    dv = v.shape[-1]
    step = _step_on_blocks if hasattr(state, 'placements') else _step
    y, state = step(state, q, k, v, log_a, normalize)
    if normalize:
        y = _normalized(y, dv)
    return y.to(q.dtype), state
