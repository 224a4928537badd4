"""Dense decoder-only transformer (yi-34b, command-r-35b, smollm-360m,
nemotron-4-15b, and chameleon-34b's backbone with qk-norm).

Parameters mirror the JAX package's tree with its [L] scan axis unstacked
into one ``Block`` a layer: ``tok`` holds ``embed``, ``final_norm`` and
(untied) ``unembed``; a block holds ``ln1``, ``ln2``, ``attn`` (``wq``,
``wk``, ``wv``, ``wo``, and ``q_norm``/``k_norm`` with qk-norm) and
``mlp`` (``w_up``, ``w_down``, and ``w_gate`` for swiglu).

The serving state is one preallocated K/V pair [L, B, T, Hkv, hd];
``decode_step`` writes each new token's K/V into it in place.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L


class Block(nn.Module):
    """One layer's parameters, from a dict of tensors."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p['ln1'])
        self.ln2 = nn.Parameter(p['ln2'])
        self.attn = nn.ParameterDict(p['attn'])
        self.mlp = nn.ParameterDict(p['mlp'])

    def _mlp(self, x, cfg):
        return x + L.mlp(self.mlp, L.rmsnorm(x, self.ln2, cfg.norm_eps), cfg)

    def train_block(self, x, cfg, positions):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        return self._mlp(x + L.attention_train(self.attn, h, cfg, positions),
                         cfg)

    def prefill_block(self, x, cfg, positions):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        y, kv = L.attention_prefill(self.attn, h, cfg, positions)
        return self._mlp(x + y, cfg), kv

    def decode_block(self, x, cfg, cache, pos: int):
        h = L.rmsnorm(x, self.ln1, cfg.norm_eps)
        y, _ = L.attention_decode(self.attn, h, cfg, cache, pos)
        return self._mlp(x + y, cfg)


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

    def _positions(self, tokens):
        b, s = tokens.shape
        return torch.arange(s, dtype=torch.int32,
                            device=tokens.device)[None].expand(b, s)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, D]; with ``cfg.remat`` each
        block's activations are recomputed in the backward pass."""
        x = L.embed(self.tok, tokens)
        positions = self._positions(tokens)
        for blk in self.blocks:
            x = L.remat(self.cfg.remat, blk.train_block, x, self.cfg,
                        positions)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.logits(self.tok, x, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] -> (logits of the last position [B, V], caches):
        the caches are the K and V of every layer, [L, B, S, Hkv, hd]."""
        x = L.embed(self.tok, tokens)
        positions = self._positions(tokens)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = blk.prefill_block(x, self.cfg, positions)
            ks.append(k)
            vs.append(v)
        return self.logits(x[:, -1:, :])[:, 0], (torch.stack(ks),
                                                 torch.stack(vs))

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, pos: int):
        """One decode step.  token [B, 1] int; caches [L, B, T, Hkv, hd]
        pair, written in place at ``pos`` for every row.  Returns (logits
        [B, V], caches)."""
        k_all, v_all = caches
        x = L.embed(self.tok, token)
        for i, blk in enumerate(self.blocks):
            x = blk.decode_block(x, self.cfg, (k_all[i], v_all[i]), pos)
        return self.logits(x)[:, 0], caches


def train_loss(params: Transformer, batch: dict, cfg, ctx) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch`` (``tokens``,
    ``labels``; -1 labels ignored).  ``cfg`` is the model's own."""
    h = params(batch['tokens'])
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg)


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
