"""Whisper-style encoder-decoder backbone (whisper-base).

As in the JAX package, the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings [B, S_enc, d_model], and one linear
``frontend_proj`` stands in for the projection out of the conv stack.
Positions are rope throughout.  The decoder is causal self-attention,
cross-attention over the encoder states, and an MLP.
"""
from __future__ import annotations

import torch

from . import layers as L
from .params import LM, positions


class Whisper(LM):
    """``params``: ``{'tok', 'frontend_proj', 'enc': [one dict a layer],
    'dec': [one dict a layer], 'enc_norm'}``; an encoder layer holds
    ``ln1``, ``ln2``, ``attn``, ``mlp``, a decoder layer also ``ln3`` and
    ``cross``."""

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S_enc, D] (stub embeddings) -> encoder states."""
        cfg = self.cfg
        b, s, _ = frames.shape
        x = frames @ self.frontend_proj
        pos = positions(b, s, frames.device)
        for p in self.enc:
            x = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1,
                                                        cfg.norm_eps),
                                      cfg, pos, causal=False)
            x = x + L.mlp(p.mlp, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
        return L.rmsnorm(x, self.enc_norm, cfg.norm_eps)

    def _cross_mlp(self, p, x, kv):
        cfg = self.cfg
        x = x + L.attention_cross(p.cross, L.rmsnorm(x, p.ln2, cfg.norm_eps),
                                  cfg, kv)
        return x + L.mlp(p.mlp, L.rmsnorm(x, p.ln3, cfg.norm_eps), cfg)

    def decode_train(self, tokens: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder over tokens [B, S] -> final hidden."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed(self.tok, tokens)
        pos = positions(b, s, tokens.device)
        for p in self.dec:
            x = x + L.attention_train(p.attn, L.rmsnorm(x, p.ln1,
                                                        cfg.norm_eps),
                                      cfg, pos, causal=True)
            x = self._cross_mlp(p, x, L.cross_kv(p.cross, enc_out, cfg))
        return x

    @torch.no_grad()
    def prepare_cross(self, frames: torch.Tensor) -> tuple:
        """Encode once; each decoder layer's cross k/v, stacked: a pair of
        [L, B, S_enc, Hkv, hd]."""
        enc_out = self.encode(frames)
        ks, vs = zip(*(L.cross_kv(p.cross, enc_out, self.cfg)
                       for p in self.dec))
        return torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: tuple, cross: tuple,
                    pos: int):
        """One decoder step.  ``caches``: the self-attention K/V pair [L, B,
        T, Hkv, hd], written in place at ``pos``; ``cross``: the pair of
        ``prepare_cross``.  Returns (logits [B, V], caches)."""
        cfg = self.cfg
        x = L.embed(self.tok, token)
        for i, p in enumerate(self.dec):
            h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
            y, _ = L.attention_decode(p.attn, h, cfg,
                                      (caches[0][i], caches[1][i]), pos)
            x = self._cross_mlp(p, x + y, (cross[0][i], cross[1][i]))
        return self.logits(x)[:, 0], caches


def train_loss(params: Whisper, batch: dict, cfg, ctx) -> torch.Tensor:
    """The decoder's mean next-token cross entropy of ``batch``
    (``tokens``, ``labels``, and the ``frames`` it attends to).  The
    reference has no remat here.  ``cfg`` is the model's own."""
    h = params.decode_train(batch['tokens'], params.encode(batch['frames']))
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg)


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
