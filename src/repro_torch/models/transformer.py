"""Dense decoder-only transformer (yi-34b, command-r-35b, smollm-360m,
nemotron-4-15b, and chameleon-34b's backbone with qk-norm).

Parameters mirror the JAX package's tree with its [L] scan axis unstacked
into one ``Block`` a layer: ``tok`` holds ``embed``, ``final_norm`` and
(untied) ``unembed``; a block holds ``ln1``, ``ln2``, ``attn`` (``wq``,
``wk``, ``wv``, ``wo``, and ``q_norm``/``k_norm`` with qk-norm) and
``mlp`` (``w_up``, ``w_down``, and ``w_gate`` for swiglu).

The serving state is one preallocated K/V pair [L, B, T, Hkv, hd];
``decode_step`` writes each new token's K/V into it in place.

Every entry point takes the ``ShardCtx`` (``ctx``, none by default) and
calls its hooks where the JAX package's ``transformer`` does, its layers
too: on parameters and a batch laid out as DTensors
(``registry.shard_step_inputs``) the model runs partitioned, and so does
the decode step on parameters, caches and token laid out by
``registry.shard_decode_inputs`` (each layer's cache ``k_all[i]`` a view
of the stack's blocks, so the writes land in the stack).
"""
from __future__ import annotations

import torch
from torch import nn

from ..runtime.sharding import ShardCtx, unshard_dims
from . import layers as L
from .params import positions


class Block(nn.Module):
    """One layer's parameters, from a dict of tensors."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p['ln1'])
        self.ln2 = nn.Parameter(p['ln2'])
        self.attn = nn.ParameterDict(p['attn'])
        self.mlp = nn.ParameterDict(p['mlp'])

    def _mlp(self, x, cfg, ctx):
        return ctx.btd(x + L.mlp(ctx.weights(self.mlp),
                                 L.rmsnorm(x, self.ln2, cfg.norm_eps), cfg,
                                 ctx))

    def train_block(self, x, cfg, positions, ctx: ShardCtx = L.NO_CTX):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        return self._mlp(x + L.attention_train(ctx.weights(self.attn), h,
                                               cfg, positions, ctx=ctx),
                         cfg, ctx)

    def prefill_block(self, x, cfg, positions, ctx: ShardCtx = L.NO_CTX):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        y, kv = L.attention_prefill(ctx.weights(self.attn), h, cfg,
                                    positions, ctx)
        return self._mlp(x + y, cfg, ctx), kv

    def decode_block(self, x, cfg, cache, pos: int,
                     ctx: ShardCtx = L.NO_CTX):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        y, _ = L.attention_decode(ctx.weights(self.attn), h, cfg, cache, pos,
                                  ctx)
        return self._mlp(x + y, cfg, ctx)


class Transformer(nn.Module):
    """The model: ``params`` is ``{'tok': {...}, 'blocks': [{...}, ...]}``,
    one block dict a layer."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        if len(params['blocks']) != cfg.n_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f'{cfg.n_layers} layers')
        self.cfg = cfg
        self.tok = nn.ParameterDict(params['tok'])
        self.blocks = nn.ModuleList(Block(p) for p in params['blocks'])

    def forward(self, tokens: torch.Tensor,
                ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, D]; with ``cfg.remat`` each
        block's activations are recomputed in the backward pass."""
        x = L.embed(self.tok, tokens, ctx)
        pos = positions(tokens)
        for blk in self.blocks:
            x = L.remat(self.cfg.remat, blk.train_block, x, self.cfg, pos,
                        ctx)
        return x

    def logits(self, x: torch.Tensor,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        return L.logits(self.tok, x, self.cfg, ctx)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, ctx: ShardCtx = L.NO_CTX):
        """tokens [B, S] -> (logits of the last position [B, V], caches):
        the caches are the K and V of every layer, [L, B, S, Hkv, hd]."""
        x = L.embed(self.tok, tokens, ctx)
        pos = positions(tokens)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = blk.prefill_block(x, self.cfg, pos, ctx)
            ks.append(k)
            vs.append(v)
        # the sequence gathered whole before the last position is sliced
        last = unshard_dims(x, (1,))[:, -1:, :]
        return self.logits(last, ctx)[:, 0], (torch.stack(ks),
                                              torch.stack(vs))

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, pos: int,
                    ctx: ShardCtx = L.NO_CTX):
        """One decode step.  token [B, 1] int; caches [L, B, T, Hkv, hd]
        pair, written in place at ``pos`` for every row.  Returns (logits
        [B, V], caches)."""
        k_all, v_all = caches
        x = L.embed(self.tok, token, ctx)
        for i, blk in enumerate(self.blocks):
            x = blk.decode_block(x, self.cfg, (k_all[i], v_all[i]), pos, ctx)
        return self.logits(x, ctx)[:, 0], caches


def train_loss(params: Transformer, batch: dict, cfg,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch`` (``tokens``,
    ``labels``; -1 labels ignored).  ``cfg`` is the model's own."""
    h = params(batch['tokens'], ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg, ctx)


def init_params(gen: torch.Generator, cfg, tp: int = 1) -> Transformer:
    """Random weights from ``gen``, on ``gen``'s device: normal with std
    0.02 (``wo`` and ``w_down`` at 0.02 / sqrt(2 L)), norms at 1."""
    dtype = getattr(torch, cfg.dtype)
    tok = L.embed_params(gen, cfg, dtype, tp)

    def block():
        ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
        return {'ln1': ones, 'ln2': ones.clone(),
                'attn': L.attention_params(gen, cfg, dtype, tp),
                'mlp': L.mlp_params(gen, cfg, dtype)}

    return Transformer(cfg, {'tok': tok,
                             'blocks': [block() for _ in range(cfg.n_layers)]})


def init_kv_cache(cfg, batch: int, max_seq: int, tp: int = 1, dtype=None,
                  *, device) -> tuple:
    """The per-layer stacked KV cache [L, B, T, Hkv, hd] (a pair), zeroed."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
