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
sequential scatter-add.  The expert-parallel path of the JAX package needs
a device mesh, which the port does not have yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _dispatch_compute_combine(xf, weights, top_idx, w_up, w_gate, w_down,
                              cfg, cap: int):
    """Sort-based dispatch -> expert FFN -> combine.  xf [n, d]; returns
    ([n, d], drop fraction)."""
    n, d = xf.shape
    k = top_idx.shape[1]
    e = w_up.shape[0]
    plan = dispatch(top_idx, cap, e)
    st, keep, slot = plan['st'], plan['keep'], plan['slot']
    sw = weights.reshape(-1)[plan['order']]

    buckets = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buckets.index_copy_(0, slot, xf[st])
    y = _expert_ffn(buckets[:-1].reshape(e, cap, d), w_up, w_gate, w_down,
                    cfg).reshape(e * cap, d)

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
    return out, _drop_frac(keep)


def _drop_frac(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` in float32 as XLA computes it: the kept count
    times float32(1/n), subtracted from 1 with one rounding (so no drop
    over 300 assignments is -2.4e-8, not 0)."""
    recip = float(torch.tensor(1.0 / keep.numel(), dtype=torch.float32))
    return (1.0 - keep.sum().double() * recip).float()


def moe_ffn(p, x: torch.Tensor, cfg):
    """x [B, S, D] -> ([B, S, D], drop fraction) through the top-k routed
    experts (and the shared expert where the config has one)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, top_idx = _route(p['router'], xf, cfg.top_k)
    out, drop = _dispatch_compute_combine(
        xf, weights, top_idx, p['w_up'], p.get('w_gate'), p['w_down'], cfg,
        moe_capacity(cfg, b * s))
    out = out.reshape(x.shape)
    if cfg.shared_expert:
        out = out + L.mlp(p['shared'], x, cfg)
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

    def _super_block(self, p, x, pos):
        """One super-block: (the dense layer, then) attention and the MoE
        FFN.  Returns (x, drop fraction)."""
        cfg = self.cfg

        def attn(pa, h):
            return L.attention_train(pa, h, cfg, pos)

        if cfg.moe_every > 1:
            x = self._dense(p, x, attn)
        x = x + attn(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps))
        y, drop = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
        return x + y, drop

    def forward(self, tokens: torch.Tensor):
        """tokens [B, S] -> (final hidden [B, S, D], mean drop fraction);
        with ``cfg.remat`` each super-block's activations are recomputed in
        the backward pass (its routing too, to the same choices)."""
        b, s = tokens.shape
        x = L.embed(self.tok, tokens)
        pos = positions(b, s, tokens.device)
        drops = []
        for p in self.blocks:
            x, drop = L.remat(self.cfg.remat, self._super_block, p, x, pos)
            drops.append(drop)
        return x, torch.stack(drops).mean()

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: tuple, pos: int):
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
            y, _ = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
            x = x + y
        return self.logits(x)[:, 0], caches


def train_loss(params: MoE, batch: dict, cfg, ctx) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``; the drop fraction is
    not part of the loss, as in the JAX package.  ``cfg`` is the model's
    own."""
    h, _ = params(batch['tokens'])
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
