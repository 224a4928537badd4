"""Whisper-style encoder-decoder backbone (whisper-base).

As in the JAX package, the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings [B, S_enc, d_model], and one linear
``frontend_proj`` stands in for the projection out of the conv stack.
Positions are rope throughout.  The decoder is causal self-attention,
cross-attention over the encoder states, and an MLP.

Every entry point takes the ``ShardCtx`` (``ctx``, none by default) and
calls its hooks where the JAX package's ``whisper`` does, its layers too:
on parameters, frames and tokens laid out as DTensors (``registry``,
recipe ``dp``: the parameters replicated, the batch over pod x data, the
residual sequence over ``model``) the model runs partitioned, the
attention on each rank's heads, and so does the decode step on a state
laid out by ``decode_state_specs`` (each layer's self-attention cache
``caches[0][i]`` a view of the stack's blocks, so the writes at ``pos``
land in the stack; the cross pair re-laid from sequence to heads over
``model`` in each layer, as JAX's ``bthd`` constraint lays it).
"""
from __future__ import annotations

import torch

from ..runtime.sharding import ShardCtx
from . import layers as L
from .params import LM, positions


class Whisper(LM):
    """``params``: ``{'tok', 'frontend_proj', 'enc': [one dict a layer],
    'dec': [one dict a layer], 'enc_norm'}``; an encoder layer holds
    ``ln1``, ``ln2``, ``attn``, ``mlp``, a decoder layer also ``ln3`` and
    ``cross``.  Under the recipe ``dp`` ``ctx.weights`` has nothing to
    gather; it is called where the dense family calls it."""

    def encode(self, frames: torch.Tensor,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        """frames [B, S_enc, D] (stub embeddings) -> encoder states."""
        cfg = self.cfg
        x = ctx.btd(L.project(frames, self.frontend_proj)[0])
        pos = positions(frames)
        for p in self.enc:
            x = x + L.attention_train(ctx.weights(p.attn),
                                      L.rmsnorm(x, p.ln1, cfg.norm_eps),
                                      cfg, pos, causal=False, ctx=ctx)
            x = x + L.mlp(ctx.weights(p.mlp),
                          L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg, ctx)
            x = ctx.btd(x)
        return L.rmsnorm(x, self.enc_norm, cfg.norm_eps)

    def _cross_mlp(self, p, x, kv, ctx: ShardCtx):
        cfg = self.cfg
        x = x + L.attention_cross(ctx.weights(p.cross),
                                  L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg, kv,
                                  ctx)
        x = x + L.mlp(ctx.weights(p.mlp), L.rmsnorm(x, p.ln3, cfg.norm_eps),
                      cfg, ctx)
        return ctx.btd(x)

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                     ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        """Teacher-forced decoder over tokens [B, S] -> final hidden."""
        cfg = self.cfg
        x = L.embed(self.tok, tokens, ctx)
        pos = positions(tokens)
        for p in self.dec:
            x = x + L.attention_train(ctx.weights(p.attn),
                                      L.rmsnorm(x, p.ln1, cfg.norm_eps),
                                      cfg, pos, causal=True, ctx=ctx)
            kv = L.cross_kv(ctx.weights(p.cross), enc_out, cfg, ctx)
            x = self._cross_mlp(p, x, kv, ctx)
        return x

    @torch.no_grad()
    def prepare_cross(self, frames: torch.Tensor,
                      ctx: ShardCtx = L.NO_CTX) -> tuple:
        """Encode once; each decoder layer's cross k/v, stacked: a pair of
        [L, B, S_enc, Hkv, hd]."""
        enc_out = self.encode(frames, ctx)
        ks, vs = zip(*(L.cross_kv(ctx.weights(p.cross), enc_out, self.cfg,
                                  ctx)
                       for p in self.dec))
        return torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: tuple, cross: tuple,
                    pos: int, ctx: ShardCtx = L.NO_CTX):
        """One decoder step.  ``caches``: the self-attention K/V pair [L, B,
        T, Hkv, hd], written in place at ``pos``; ``cross``: the pair of
        ``prepare_cross``.  Returns (logits [B, V], caches)."""
        cfg = self.cfg
        x = L.embed(self.tok, token, ctx)
        for i, p in enumerate(self.dec):
            h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
            y, _ = L.attention_decode(ctx.weights(p.attn), h, cfg,
                                      (caches[0][i], caches[1][i]), pos, ctx)
            x = self._cross_mlp(p, x + y, (cross[0][i], cross[1][i]), ctx)
        return self.logits(x, ctx)[:, 0], caches


def train_loss(params: Whisper, batch: dict, cfg,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
    """The decoder's mean next-token cross entropy of ``batch``
    (``tokens``, ``labels``, and the ``frames`` it attends to).  The
    reference has no remat here.  ``cfg`` is the model's own."""
    h = params.decode_train(batch['tokens'],
                            params.encode(batch['frames'], ctx), ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg, ctx)


def init_params(gen: torch.Generator, cfg, tp: int = 1) -> Whisper:
    dtype = getattr(torch, cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    def enc_block():
        return {'ln1': ones(), 'ln2': ones(),
                'attn': L.attention_params(gen, cfg, dtype, tp),
                'mlp': L.mlp_params(gen, cfg, dtype)}

    def dec_block():
        return {'ln1': ones(), 'ln2': ones(), 'ln3': ones(),
                'attn': L.attention_params(gen, cfg, dtype, tp),
                'cross': L.attention_params(gen, cfg, dtype, tp),
                'mlp': L.mlp_params(gen, cfg, dtype)}

    return Whisper(cfg, {
        'tok': L.embed_params(gen, cfg, dtype, tp),
        'frontend_proj': L.dense_init(gen, cfg.d_model, cfg.d_model, dtype),
        'enc': [enc_block() for _ in range(cfg.enc_layers or cfg.n_layers)],
        'dec': [dec_block() for _ in range(cfg.n_layers)],
        'enc_norm': ones()})


def init_kv_cache(cfg, batch: int, max_seq: int, tp: int = 1, dtype=None, *,
                  device) -> tuple:
    """The decoder's self-attention K/V pair [L, B, T, Hkv, hd], zeroed."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
