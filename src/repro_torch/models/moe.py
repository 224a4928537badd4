"""Mixture-of-Experts transformer (granite-moe-1b top-8, llama4-maverick
top-1), the JAX package's local path.

Token dispatch is sort-based: the assignments are sorted by expert id with
one stable sort, ranked within their expert, and written into
fixed-capacity buckets [E, C, D]; the expert FFNs run as batched products
over the expert axis.  Capacity overflow drops assignments (GShard
semantics), and the dropped fraction is returned beside the output.

Maverick: an MoE layer every other layer (``moe_every=2``: each block is
a dense layer then an MoE layer), an always-on shared expert added to the
routed output, and a sigmoid gate for top-1.

Nothing here uses atomics, so a run on the card is deterministic: the
bucket write hits distinct rows (the dropped ones share one spare row that
is cut off), and the combine gathers each token's contributions and adds
them from zero in ascending expert order, the order of the reference's
sequential scatter-add.

On a device mesh whose ``model`` axis divides both the sequence and the
expert count, ``moe_ffn`` takes the expert-parallel path of the JAX
package (``_moe_ffn_ep``), as a per-rank body: each rank dispatches its own
tokens into buckets of per-rank capacity, an ``all_to_all`` over ``model``
sends each expert's slices to the expert's owner, the experts' weights are
gathered over ``data``, a reverse ``all_to_all`` brings the results home,
and the output is gathered back to every rank (``runtime.spmd``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime import spmd
from ..runtime.sharding import P, ShardCtx, batch_axes, mesh_axes
from . import layers as L
from .params import LM, positions


def moe_capacity(cfg, n_tokens: int) -> int:
    """Assignments an expert takes, rounded up to a multiple of 128."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return (c + 127) // 128 * 128


def moe_params(gen: torch.Generator, cfg, dtype) -> dict:
    """The router (float32), the experts' [E, d, f] and [E, f, d] weights,
    and for maverick the shared expert."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        'router': L.normal(gen, (d, e), torch.float32),
        'w_up': L.normal(gen, (e, d, f), dtype),
        'w_down': L.normal(gen, (e, f, d), dtype,
                           0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.act == 'swiglu':
        p['w_gate'] = L.normal(gen, (e, d, f), dtype)
    if cfg.shared_expert:
        p['shared'] = L.mlp_params(gen, cfg, dtype)
    return p


def _route(router, xf, k: int):
    """Top-k routing.  xf [n, d] -> (weights [n, k], expert ids [n, k])."""
    rl = xf.float() @ router                               # [n, E]
    top_vals, top_idx = torch.topk(rl, k, dim=-1)
    if k == 1:
        return torch.sigmoid(top_vals), top_idx            # llama4-style gate
    return torch.softmax(top_vals, dim=-1), top_idx


def _expert_ffn(buckets, w_up, w_gate, w_down, cfg):
    """[E, C, d] -> [E, C, d]: each expert's FFN on its bucket."""
    up = torch.bmm(buckets, w_up)
    if cfg.act == 'swiglu':
        h = F.silu(torch.bmm(buckets, w_gate)) * up
    else:
        h = torch.square(F.relu(up))
    return torch.bmm(h, w_down)


def dispatch(top_idx, cap: int, n_experts: int) -> dict:
    """The sort-based dispatch plan of expert ids [n, k]: over the n*k
    assignments in stable expert order, the token ``st`` of each, its
    ``rank`` in its expert, ``keep`` (rank < cap), its bucket row ``slot``
    (``e * cap`` where dropped), and ``order``, the sort."""
    n, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode='floor')
    starts = torch.searchsorted(se, torch.arange(n_experts, dtype=se.dtype,
                                                 device=dev))
    rank = torch.arange(n * k, device=dev) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, n_experts * cap)
    return {'order': order, 'st': st, 'rank': rank, 'keep': keep,
            'slot': slot}


def _dispatch_combine(xf, weights, top_idx, ffn, e: int, cap: int):
    """Sort-based dispatch into [E, cap, d] buckets -> ``ffn`` (buckets to
    results of the same shape) -> combine.  xf [n, d]; returns ([n, d],
    keep: which of the n*k sorted assignments found room)."""
    n, d = xf.shape
    k = top_idx.shape[1]
    plan = dispatch(top_idx, cap, e)
    st, keep, slot = plan['st'], plan['keep'], plan['slot']
    sw = weights.reshape(-1)[plan['order']]

    buckets = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buckets.index_copy_(0, slot, xf[st])
    y = ffn(buckets[:-1].reshape(e, cap, d)).reshape(e * cap, d)

    back = torch.where(keep[:, None], y[torch.clamp(slot, max=e * cap - 1)],
                       0.0).to(xf.dtype)
    contrib = back * sw[:, None].to(xf.dtype)              # sorted order
    # each token's k contributions, at their sorted positions in ascending
    # order (= ascending expert), added from zero in that order
    where = torch.empty_like(plan['order'])
    where[plan['order']] = torch.arange(n * k, device=xf.device)
    where = torch.sort(where.reshape(n, k), dim=1).values
    out = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[where[:, j]]
    return out, keep


def _dispatch_compute_combine(xf, weights, top_idx, w_up, w_gate, w_down,
                              cfg, cap: int):
    """Sort-based dispatch -> expert FFN -> combine.  xf [n, d]; returns
    ([n, d], drop fraction)."""
    out, keep = _dispatch_combine(
        xf, weights, top_idx,
        lambda b: _expert_ffn(b, w_up, w_gate, w_down, cfg),
        w_up.shape[0], cap)
    return out, _drop_frac(keep)


def _drop_frac(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` in float32 as XLA computes it: the kept count
    times float32(1/n), subtracted from 1 with one rounding (so no drop
    over 300 assignments is -2.4e-8, not 0)."""
    recip = float(torch.tensor(1.0 / keep.numel(), dtype=torch.float32))
    return (1.0 - keep.sum().double() * recip).float()


def moe_ffn(p, x: torch.Tensor, cfg, ctx: ShardCtx | None = None):
    """x [B, S, D] -> ([B, S, D], drop fraction) through the top-k routed
    experts (and the shared expert where the config has one).

    Two paths with the same routing per token group: the local one (no
    mesh, or a sequence or expert count that the ``model`` axis does not
    divide, as in decode) dispatches all tokens at once; the
    expert-parallel one (``_moe_ffn_ep``) gives each rank's tokens a
    capacity of their own, as the JAX package's does, so it may drop other
    tokens."""
    mesh = ctx.mesh if ctx is not None else None
    tp = mesh_axes(mesh).get('model')
    if tp is not None and x.shape[1] % tp == 0 and cfg.n_experts % tp == 0:
        out, drop = _moe_ffn_ep(p, x, cfg, mesh)
    else:
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        weights, top_idx = _route(p['router'], xf, cfg.top_k)
        out, drop = _dispatch_compute_combine(
            xf, weights, top_idx, p['w_up'], p.get('w_gate'), p['w_down'],
            cfg, moe_capacity(cfg, b * s))
        out = out.reshape(x.shape)
    if cfg.shared_expert:
        out = out + L.mlp(p['shared'], x, cfg)
    return out, drop


def _moe_ffn_ep(p, x: torch.Tensor, cfg, mesh):
    """The expert-parallel body on this rank, for the replicated x [B, S,
    D] and weights: returns the replicated ([B, S, D], drop fraction over
    the whole mesh).

    This rank takes the tokens of its block (batch over pod x data where
    divisible, sequence over ``model``) and its block of the experts'
    weights (experts over ``model``, rows over ``data``), as the JAX
    body's ``in_specs`` lay them out.  Gradients stay whole on every rank
    (``runtime.spmd``): the replicated inputs' are summed over the ranks
    whose tokens differ (and over ``data`` for the weights, whose rows are
    gathered over it)."""
    sizes = mesh_axes(mesh)
    tp = sizes['model']
    baxes = batch_axes(mesh)
    b, s, d = x.shape
    bshard = math.prod(sizes[a] for a in baxes)
    if b % bshard:
        baxes = ()                     # batch not divisible: replicate batch
    tok_axes = baxes + ('model',)
    e, k = cfg.n_experts, cfg.top_k
    has_data = 'data' in sizes
    # the weights' rows are gathered over 'data'; its ranks consume them
    # on different tokens only where the batch is sharded over it
    w_axes = tuple(a for a in sizes if a in tok_axes or a == 'data')
    w_grad = 'sum' if 'data' in tok_axes else 'slice'

    def weight(w, spec, dim):
        w = spmd.local_block(spmd.sum_grads(w, mesh, w_axes), mesh, spec)
        return spmd.gather(w, mesh, 'data', dim, w_grad) if has_data else w

    row = 'data' if has_data else None
    x_spec = P(baxes or None, 'model', None)
    x_loc = spmd.local_block(spmd.sum_grads(x, mesh, tok_axes), mesh, x_spec)
    router = spmd.sum_grads(p['router'], mesh, tok_axes)
    w_up = weight(p['w_up'], P('model', row, None), 1)
    w_gate = (weight(p['w_gate'], P('model', row, None), 1)
              if cfg.act == 'swiglu' else None)
    w_down = weight(p['w_down'], P('model', None, row), 2)

    bl, sl, _ = x_loc.shape
    xf = x_loc.reshape(bl * sl, d)
    cap = moe_capacity(cfg, bl * sl)     # per-rank capacity
    e_loc = e // tp

    def ffn(buckets):
        # [E, cap, d] -> rank j gets every rank's slices of its experts
        routed = spmd.all_to_all(buckets, mesh, 'model')   # [tp*E_loc, ...]
        routed = routed.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, tp * cap, d)
        y = _expert_ffn(routed, w_up, w_gate, w_down, cfg)
        y = y.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(e, cap, d)
        return spmd.all_to_all(y, mesh, 'model')           # results home

    weights, top_idx = _route(router, xf, k)
    out, keep = _dispatch_combine(xf, weights, top_idx, ffn, e, cap)
    axes = tuple(sizes)
    kept = spmd.all_reduce(keep.sum(dtype=torch.float32), mesh, axes)
    total = spmd.all_reduce(torch.tensor(float(keep.numel()),
                                         device=x.device), mesh, axes)
    drop = 1.0 - kept / total
    out = spmd.gather_block(out.reshape(bl, sl, d), mesh, x_spec)
    return out, drop


class MoE(LM):
    """``params``: ``{'tok': {...}, 'blocks': [...]}``, one block a super-
    block: ``ln1``, ``ln2``, ``attn`` and ``moe``, and with
    ``moe_every > 1`` the dense layer before it, ``attn2``, ``ln3``,
    ``mlp`` and ``ln4``."""

    def _dense(self, p, x, attn):
        """Maverick's dense layer: ``attn`` the attention's output."""
        x = x + attn(p.attn2, L.rmsnorm(x, p.ln3, self.cfg.norm_eps))
        return x + L.mlp(p.mlp, L.rmsnorm(x, p.ln4, self.cfg.norm_eps),
                         self.cfg)

    def _super_block(self, p, x, pos, ctx):
        """One super-block: (the dense layer, then) attention and the MoE
        FFN.  Returns (x, drop fraction)."""
        cfg = self.cfg

        def attn(pa, h):
            return L.attention_train(pa, h, cfg, pos)

        if cfg.moe_every > 1:
            x = self._dense(p, x, attn)
        x = x + attn(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps))
        y, drop = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg, ctx)
        return x + y, drop

    def forward(self, tokens: torch.Tensor, ctx: ShardCtx | None = None):
        """tokens [B, S] -> (final hidden [B, S, D], mean drop fraction);
        with ``cfg.remat`` each super-block's activations are recomputed in
        the backward pass (its routing too, to the same choices).  On
        ``ctx``'s mesh the MoE FFN may run expert-parallel (``moe_ffn``)."""
        b, s = tokens.shape
        x = L.embed(self.tok, tokens)
        pos = positions(b, s, tokens.device)
        drops = []
        for p in self.blocks:
            x, drop = L.remat(self.cfg.remat, self._super_block, p, x, pos,
                              ctx)
            drops.append(drop)
        return x, torch.stack(drops).mean()

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: tuple, pos: int,
                    ctx: ShardCtx | None = None):
        """One decode step.  ``caches``: the K/V pair [n_super, n_attn, B,
        T, Hkv, hd] (``n_attn`` 2 with the dense layer: index 0 is its
        attention's), written in place at ``pos``.  Returns (logits [B, V],
        caches)."""
        cfg = self.cfg
        k_all, v_all = caches
        x = L.embed(self.tok, token)
        for i, p in enumerate(self.blocks):
            def attn(pa, h, a=k_all.shape[1] - 1):
                """Attention decode on the cache of this block's
                attention ``a`` (the last: the MoE layer's)."""
                return L.attention_decode(pa, h, cfg,
                                          (k_all[i, a], v_all[i, a]), pos)[0]
            if cfg.moe_every > 1:
                x = self._dense(p, x, lambda pa, h: attn(pa, h, 0))
            x = x + attn(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps))
            y, _ = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg,
                           ctx)
            x = x + y
        return self.logits(x)[:, 0], caches


def train_loss(params: MoE, batch: dict, cfg, ctx) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``; the drop fraction is
    not part of the loss, as in the JAX package.  ``cfg`` is the model's
    own."""
    h, _ = params(batch['tokens'], ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg)


def init_params(gen: torch.Generator, cfg, tp: int = 1) -> MoE:
    dtype = getattr(torch, cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    def block():
        prm = {'ln1': ones(), 'ln2': ones(),
               'attn': L.attention_params(gen, cfg, dtype, tp)}
        if cfg.moe_every > 1:
            prm.update(mlp=L.mlp_params(gen, cfg, dtype),
                       attn2=L.attention_params(gen, cfg, dtype, tp),
                       ln3=ones(), ln4=ones())
        prm['moe'] = moe_params(gen, cfg, dtype)
        return prm

    return MoE(cfg, {'tok': L.embed_params(gen, cfg, dtype, tp),
                     'blocks': [block()
                                for _ in range(cfg.n_layers
                                               // cfg.moe_every)]})


def init_kv_cache(cfg, batch: int, max_seq: int, tp: int = 1, dtype=None, *,
                  device) -> tuple:
    """The K/V pair [n_super, n_attn, B, T, Hkv, hd], zeroed."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers // cfg.moe_every, 2 if cfg.moe_every > 1 else 1,
             batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim())
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
