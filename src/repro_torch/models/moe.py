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
gathered over ``data``, and a reverse ``all_to_all`` brings the results
home (``runtime.spmd``).  The body takes its inputs in either of two
layouts: replicated values (every rank holds the whole ``x`` and weights,
slices its block and gathers the output back whole), or the partitioned
program's DTensors (``registry.shard_step_inputs``), whose blocks it
takes as they lie and whose output it returns as a DTensor in ``x``'s
layout.

Every entry point takes the ``ShardCtx`` and calls its hooks where the
JAX package's ``moe`` does: on the partitioned layout the attention,
embeddings, norms, the shared expert and the unembedding run on each
rank's blocks as the dense family's do (``transformer``).  Where the
sequence does not divide ``model`` (decode: one token) the local path runs
on a DTensor as one dispatch over every token, as JAX's does: the tokens
gathered whole, the routing the same on every rank, each rank's FFN only
on its own experts (their rows gathered over ``data``, never the whole
stack), the results gathered over ``model`` and combined.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime import spmd
from ..runtime.sharding import (P, ShardCtx, batch_axes, mesh_axes,
                                spec_to_placements)
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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def moe_ffn(p, x: torch.Tensor, cfg, ctx: ShardCtx = L.NO_CTX):
    """x [B, S, D] -> ([B, S, D], drop fraction) through the top-k routed
    experts (and the shared expert where the config has one).

    Two paths with the same routing per token group: the local one (no
    mesh, or a sequence or expert count that the ``model`` axis does not
    divide, as in decode) dispatches all tokens at once; the
    expert-parallel one (``_moe_ffn_ep``) gives each rank's tokens a
    capacity of their own, as the JAX package's does, so it may drop other
    tokens."""
    tp = mesh_axes(ctx.mesh).get('model')
    if tp is not None and x.shape[1] % tp == 0 and cfg.n_experts % tp == 0:
        out, drop = _moe_ffn_ep(p, x, cfg, ctx.mesh)
    elif _is_dtensor(x):
        out, drop = _moe_ffn_local_split(p, x, cfg)
    else:
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        weights, top_idx = _route(p['router'], xf, cfg.top_k)
        out, drop = _dispatch_compute_combine(
            xf, weights, top_idx, p['w_up'], p.get('w_gate'), p['w_down'],
            cfg, moe_capacity(cfg, b * s))
        out = out.reshape(x.shape)
    if cfg.shared_expert:
        out = out + L.mlp(ctx.weights(p['shared']), x, cfg, ctx)
    return ctx.btd(out), drop


_EXPERT_NAMES = ('w_up', 'w_gate', 'w_down')


def _expert_specs(mesh, expert_axis) -> dict:
    """The specs of the experts' weights in the expert-parallel body
    (the JAX body's ``in_specs``): experts over ``expert_axis``, their
    d_model rows over ``data``."""
    row = 'data' if 'data' in mesh_axes(mesh) else None
    return {'w_up': P(expert_axis, row, None),
            'w_gate': P(expert_axis, row, None),
            'w_down': P(expert_axis, None, row)}


def _block_of(w, mesh, spec: P, grad_axes=()):
    """This rank's block of the DTensor ``w`` laid out by ``spec`` (moved
    there first if it lies otherwise), as a plain tensor.  Its gradient is
    declared: the block's own on the axes that ``spec`` shards, a pending
    sum on ``grad_axes`` (those whose ranks consume the block on different
    tokens), replicated on the rest."""
    from torch.distributed.tensor import Partial, Replicate
    pl = spec_to_placements(spec, mesh)
    if tuple(w.placements) != tuple(pl):
        w = w.redistribute(mesh, pl)
    grad = [q if q.is_shard() else Partial() if a in grad_axes
            else Replicate() for a, q in zip(mesh_axes(mesh), pl)]
    return w.to_local(grad_placements=grad)


def _gather_rows(w, mesh, spec: P, grad: str):
    """A rank's block of an expert weight with its ``data`` rows gathered
    (the FSDP gather), for the layer's products."""
    for dim, entry in enumerate(spec):
        if entry == 'data':
            return spmd.gather(w, mesh, 'data', dim, grad)
    return w


def _moe_ffn_ep(p, x: torch.Tensor, cfg, mesh):
    """The expert-parallel body on this rank: returns ([B, S, D], drop
    fraction over the whole mesh, replicated).

    The body works on the tokens of this rank's block (batch over pod x
    data where divisible, sequence over ``model``), the router replicated
    and its block of the experts' weights (experts over ``model``, rows
    over ``data``), as the JAX body's ``in_specs`` lay them out.  Two
    layouts of the inputs:

      * DTensors (the partitioned program): each input's block as it lies
        (``x`` laid out first as the body's spec); the output is a DTensor
        in that layout.  The gradients are declared where the blocks are
        taken: the router's, computed on each rank's tokens, is a pending
        sum over the token ranks; an expert block's is its own, summed
        over ``pod`` where its ranks' tokens differ;
      * replicated tensors: each rank slices its blocks and the output is
        gathered back whole.  Gradients stay whole on every rank
        (``runtime.spmd``): the replicated inputs' are summed over the
        ranks whose tokens differ (and over ``data`` for the weights,
        whose rows are gathered over it).

    In both, the weights' rows are gathered over ``data`` with a gradient
    summed back over it where the batch is sharded over it (the transpose
    of JAX's ``all_gather``), else sliced."""
    sizes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    b, s, d = x.shape
    if b % math.prod(sizes[a] for a in baxes):
        baxes = ()                     # batch not divisible: replicate batch
    tok_axes = baxes + ('model',)
    x_spec = P(baxes or None, 'model', None)
    specs = _expert_specs(mesh, 'model')
    names = [n for n in _EXPERT_NAMES if n in p]
    w_grad = 'sum' if 'data' in tok_axes else 'slice'
    if _is_dtensor(x):
        x_pl = spec_to_placements(x_spec, mesh)
        if tuple(x.placements) != tuple(x_pl):
            x = x.redistribute(mesh, x_pl)
        x_loc = x.to_local()
        router = _block_of(p['router'], mesh, P(), tok_axes)
        ws = {n: _block_of(p[n], mesh, specs[n], tok_axes) for n in names}
    else:
        # the weights' rows are gathered over 'data'; its ranks consume
        # them on different tokens only where the batch is sharded over it
        w_axes = tuple(a for a in sizes if a in tok_axes or a == 'data')
        x_loc = spmd.local_block(spmd.sum_grads(x, mesh, tok_axes), mesh,
                                 x_spec)
        router = spmd.sum_grads(p['router'], mesh, tok_axes)
        ws = {n: spmd.local_block(spmd.sum_grads(p[n], mesh, w_axes), mesh,
                                  specs[n]) for n in names}
    ws = {n: _gather_rows(w, mesh, specs[n], w_grad) for n, w in ws.items()}

    bl, sl, _ = x_loc.shape
    xf = x_loc.reshape(bl * sl, d)
    cap = moe_capacity(cfg, bl * sl)     # per-rank capacity
    e, tp = cfg.n_experts, sizes['model']
    e_loc = e // tp

    def ffn(buckets):
        # [E, cap, d] -> rank j gets every rank's slices of its experts
        routed = spmd.all_to_all(buckets, mesh, 'model')   # [tp*E_loc, ...]
        routed = routed.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, tp * cap, d)
        y = _expert_ffn(routed, ws['w_up'], ws.get('w_gate'), ws['w_down'],
                        cfg)
        y = y.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(e, cap, d)
        return spmd.all_to_all(y, mesh, 'model')           # results home

    weights, top_idx = _route(router, xf, cfg.top_k)
    out, keep = _dispatch_combine(xf, weights, top_idx, ffn, e, cap)
    axes = tuple(sizes)
    kept = spmd.all_reduce(keep.sum(dtype=torch.float32), mesh, axes)
    total = spmd.all_reduce(torch.tensor(float(keep.numel()),
                                         device=xf.device), mesh, axes)
    drop = 1.0 - kept / total
    out = out.reshape(bl, sl, d)
    if _is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, mesh, x.placements, shape=x.shape,
                                  stride=x.stride()), drop
    return spmd.gather_block(out, mesh, x_spec), drop


def _moe_ffn_local_split(p, x, cfg):
    """The local path on a DTensor ``x`` [B, S, D] (decode: S = 1 does not
    divide ``model``): one dispatch of all B*S tokens at the global
    capacity, as JAX's local path.  The tokens are gathered whole and
    routed the same on every rank; each rank runs the FFN of its own
    experts only (experts over ``model`` where it divides them, their rows
    gathered over ``data``), and the results are gathered over ``model``
    for the combine.  Returns ([B, S, D] in ``x``'s layout, the drop
    fraction, the same on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    sizes = mesh_axes(mesh)
    b, s, d = x.shape
    e = cfg.n_experts
    tp = sizes.get('model', 1)
    eax = 'model' if 'model' in sizes and e % tp == 0 else None
    e_loc = e // tp if eax else e
    specs = _expert_specs(mesh, eax)
    whole = [Replicate()] * mesh.ndim
    xf = x.redistribute(mesh, whole).to_local().reshape(b * s, d)
    router = _block_of(p['router'], mesh, P())
    # every rank computes the same products: each block's gradient is its
    # own, and the gathered rows' are sliced back
    ws = {n: _gather_rows(_block_of(p[n], mesh, specs[n]), mesh, specs[n],
                          'slice')
          for n in _EXPERT_NAMES if n in p}
    first = spmd.coord(mesh, eax) * e_loc if eax else 0

    def ffn(buckets):
        y = _expert_ffn(buckets.narrow(0, first, e_loc), ws['w_up'],
                        ws.get('w_gate'), ws['w_down'], cfg)
        return spmd.gather(y, mesh, eax, 0, 'slice') if eax else y

    weights, top_idx = _route(router, xf, cfg.top_k)
    out, keep = _dispatch_combine(xf, weights, top_idx, ffn, e,
                                  moe_capacity(cfg, b * s))
    out = DTensor.from_local(out.reshape(b, s, d), mesh, whole)
    return out.redistribute(mesh, x.placements), _drop_frac(keep)


class MoE(LM):
    """``params``: ``{'tok': {...}, 'blocks': [...]}``, one block a super-
    block: ``ln1``, ``ln2``, ``attn`` and ``moe``, and with
    ``moe_every > 1`` the dense layer before it, ``attn2``, ``ln3``,
    ``mlp`` and ``ln4``."""

    def _dense(self, p, x, attn, ctx: ShardCtx):
        """Maverick's dense layer: ``attn`` the attention's output."""
        x = x + attn(p.attn2, L.rmsnorm(x, p.ln3, self.cfg.norm_eps))
        return x + L.mlp(ctx.weights(p.mlp),
                         L.rmsnorm(x, p.ln4, self.cfg.norm_eps), self.cfg,
                         ctx)

    def _super_block(self, p, x, pos, ctx: ShardCtx):
        """One super-block: (the dense layer, then) attention and the MoE
        FFN.  Returns (x, drop fraction)."""
        cfg = self.cfg

        def attn(pa, h):
            return L.attention_train(ctx.weights(pa), h, cfg, pos, ctx=ctx)

        if cfg.moe_every > 1:
            x = self._dense(p, x, attn, ctx)
        x = x + attn(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps))
        y, drop = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg, ctx)
        return ctx.btd(x + y), drop

    def forward(self, tokens: torch.Tensor, ctx: ShardCtx = L.NO_CTX):
        """tokens [B, S] -> (final hidden [B, S, D], mean drop fraction);
        with ``cfg.remat`` each super-block's activations are recomputed in
        the backward pass (its routing too, to the same choices).  On
        ``ctx``'s mesh the MoE FFN may run expert-parallel (``moe_ffn``);
        on tokens laid out as a DTensor the whole model runs partitioned,
        the positions laid out as the tokens."""
        x = L.embed(self.tok, tokens, ctx)
        pos = positions(tokens)
        drops = []
        for p in self.blocks:
            x, drop = L.remat(self.cfg.remat, self._super_block, p, x, pos,
                              ctx)
            drops.append(drop)
        return x, torch.stack(drops).mean()

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: tuple, pos: int,
                    ctx: ShardCtx = L.NO_CTX):
        """One decode step.  ``caches``: the K/V pair [n_super, n_attn, B,
        T, Hkv, hd] (``n_attn`` 2 with the dense layer: index 0 is its
        attention's), written in place at ``pos`` (on DTensors each
        ``k_all[i, a]`` is a view of the stack's blocks, so the writes land
        in the stack).  Returns (logits [B, V], caches)."""
        cfg = self.cfg
        k_all, v_all = caches
        x = L.embed(self.tok, token, ctx)
        for i, p in enumerate(self.blocks):
            def attn(pa, h, a=k_all.shape[1] - 1):
                """Attention decode on the cache of this block's
                attention ``a`` (the last: the MoE layer's)."""
                return L.attention_decode(ctx.weights(pa), h, cfg,
                                          (k_all[i, a], v_all[i, a]), pos,
                                          ctx)[0]
            if cfg.moe_every > 1:
                x = self._dense(p, x, lambda pa, h: attn(pa, h, 0), ctx)
            x = x + attn(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps))
            y, _ = moe_ffn(p.moe, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg,
                           ctx)
            x = ctx.btd(x + y)
        return self.logits(x, ctx)[:, 0], caches


def train_loss(params: MoE, batch: dict, cfg,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``; the drop fraction is
    not part of the loss, as in the JAX package.  ``cfg`` is the model's
    own."""
    h, _ = params(batch['tokens'], ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg, ctx)


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
