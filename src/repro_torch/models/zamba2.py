"""Zamba2 hybrid (zamba2-1.2b): a Mamba2 backbone and ONE shared attention
+ MLP block applied after every ``attn_every``-th layer.  The block's
weights appear once (``shared``) and every point reuses them; each point
keeps its own K/V cache.

Every entry point takes the ``ShardCtx`` (``ctx``, none by default) and
calls its hooks where the JAX package's ``zamba2`` does: on parameters, a
batch and a decode state laid out as DTensors (``registry``, recipe
``ssm``) the Mamba2 layers run partitioned by heads (``mamba2``), and
the shared block runs the dense family's partitioned attention and MLP
(``layers``) on its weights with their FSDP shards gathered
(``ShardCtx.weights``); each point's K/V cache ``kv_k[i]`` is a view of
the stack's blocks, so the decode's writes at ``pos`` land in the stack
(``layers.write_at``), and each layer's new SSD state and conv window
are written into their views of the stacked states (``layers.store``).
"""
from __future__ import annotations

import torch

from ..runtime.sharding import ShardCtx
from . import layers as L
from . import mamba2
from .params import LM, positions


def _attn_points(cfg) -> list[int]:
    ae = cfg.attn_every or (cfg.n_layers + 1)
    return [l for l in range(cfg.n_layers) if (l + 1) % ae == 0]


def _segments(cfg) -> list[tuple[int, int]]:
    """The runs of Mamba2 layers [lo, hi): segment i ends at attention
    point i, and the layers after the last point make one more."""
    bounds = [0] + [p + 1 for p in _attn_points(cfg)]
    if bounds[-1] != cfg.n_layers:
        bounds.append(cfg.n_layers)
    return list(zip(bounds[:-1], bounds[1:]))


class Zamba2(LM):
    """``params``: ``{'tok': {...}, 'mamba': [one dict a layer], 'shared':
    {'ln1', 'ln2', 'attn', 'mlp'}}``."""

    def _mamba(self, l: int, x, ctx: ShardCtx):
        """Mamba2 layer ``l``, its weights' FSDP shards gathered inside
        (so a recompute gathers them again, rather than holding them)."""
        return mamba2.mamba_block(ctx.weights(self.mamba[l]), x, self.cfg,
                                  ctx)

    def _shared_mlp(self, x, ctx: ShardCtx):
        p = self.shared
        return ctx.btd(x + L.mlp(ctx.weights(p.mlp),
                                 L.rmsnorm(x, p.ln2, self.cfg.norm_eps),
                                 self.cfg, ctx))

    def forward(self, tokens: torch.Tensor,
                ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, D]; with ``cfg.remat`` each
        Mamba2 layer's activations are recomputed in the backward pass (the
        shared attention block's are kept, as in the JAX package).  On
        tokens laid out as a DTensor the positions are laid out as the
        tokens."""
        cfg = self.cfg
        x = L.embed(self.tok, tokens, ctx)
        pos = positions(tokens)
        n_pts = len(_attn_points(cfg))
        p = self.shared
        for si, (lo, hi) in enumerate(_segments(cfg)):
            for l in range(lo, hi):
                x = L.remat(cfg.remat, self._mamba, l, x, ctx)
            if si < n_pts:
                h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
                x = self._shared_mlp(x + L.attention_train(
                    ctx.weights(p.attn), h, cfg, pos, ctx=ctx), ctx)
        return x

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict, pos: int,
                    ctx: ShardCtx = L.NO_CTX):
        """One decode step; ``state`` (``init_state``'s) is written in
        place: each layer's Mamba2 state, and at attention point i the K/V
        of ``kv_k[i]``/``kv_v[i]`` at ``pos``.  Returns (logits [B, V],
        state)."""
        cfg = self.cfg
        x = L.embed(self.tok, token, ctx)
        ssm, conv = state['ssm']['ssm'], state['ssm']['conv']
        n_pts = len(_attn_points(cfg))
        p = self.shared
        for si, (lo, hi) in enumerate(_segments(cfg)):
            for l in range(lo, hi):
                x, new = mamba2.mamba_decode(
                    ctx.weights(self.mamba[l]), x,
                    {'ssm': ssm[l], 'conv': conv[l]}, cfg, ctx)
                L.store(ssm[l], new['ssm'])
                L.store(conv[l], new['conv'])
            if si < n_pts:
                h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
                y, _ = L.attention_decode(
                    ctx.weights(p.attn), h, cfg,
                    (state['kv_k'][si], state['kv_v'][si]), pos, ctx)
                x = self._shared_mlp(x + y, ctx)
        return self.logits(x, ctx)[:, 0], state


def train_loss(params: Zamba2, batch: dict, cfg,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``.  ``cfg`` is the
    model's own."""
    h = params(batch['tokens'], ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg, ctx)


def init_params(gen: torch.Generator, cfg, tp: int = 1) -> Zamba2:
    dtype = getattr(torch, cfg.dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,  # noqa: E731
                              device=gen.device)
    return Zamba2(cfg, {
        'tok': L.embed_params(gen, cfg, dtype, tp),
        'mamba': [mamba2.mamba_params(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)],
        'shared': {'ln1': ones(), 'ln2': ones(),
                   'attn': L.attention_params(gen, cfg, dtype, tp),
                   'mlp': L.mlp_params(gen, cfg, dtype)}})


def init_state(cfg, batch: int, max_seq: int, tp: int = 1, dtype=None, *,
               device) -> dict:
    """``ssm``: every layer's Mamba2 state stacked on a leading [L] axis;
    ``kv_k``/``kv_v``: each attention point's cache [n_pts, B, T, Hkv,
    hd].  Zeroed."""
    dtype = dtype or getattr(torch, cfg.dtype)
    kv_shape = (len(_attn_points(cfg)), batch, max_seq, cfg.n_kv_heads,
                cfg.resolved_head_dim())
    one = mamba2.init_state(cfg, batch, device=device)
    return {'ssm': {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                   device=device) for k, v in one.items()},
            'kv_k': torch.zeros(kv_shape, dtype=dtype, device=device),
            'kv_v': torch.zeros(kv_shape, dtype=dtype, device=device)}
