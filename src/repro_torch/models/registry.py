"""Architecture registry: one interface over the model families, for
training and serving.

Per config: ``init_params`` (random weights from a seeded generator),
``make_ctx`` / ``tp_of``, the train step ``make_train_step`` (the family's
``train_loss``, its gradients by autograd, and ``optim.adam.step``), and
the serving entry points ``make_prefill``, ``make_decode_step`` and
``init_decode_state``, with the JAX package's branch for each family:
``dense`` and ``vlm`` (chameleon's backbone is dense with qk-norm),
``moe``, ``encdec`` (whisper), ``ssm`` (xlstm) and ``hybrid`` (zamba2).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..optim import adam
from ..runtime.sharding import ShardCtx
from . import moe, transformer, whisper, xlstm, zamba2

_FAMILY = {
    'dense': transformer,
    'vlm': transformer,      # chameleon backbone == dense + qk_norm
    'moe': moe,
    'encdec': whisper,
    'ssm': xlstm,
    'hybrid': zamba2,
}


def module_for(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def init_params(seed: int, cfg: ModelConfig, tp: int = 1, *, device=None):
    """The model with random weights from a generator seeded ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return module_for(cfg).init_params(gen, cfg, tp)


def make_ctx(mesh, cfg: ModelConfig) -> ShardCtx:
    return ShardCtx(recipe=cfg.recipe, tp=tp_of(mesh, cfg))


def tp_of(mesh, cfg: ModelConfig) -> int:
    if mesh is not None:
        raise NotImplementedError('the port has no device mesh yet '
                                  '(ROADMAP queue 1, item 3c)')
    return 1


def make_train_step(cfg: ModelConfig, ctx: ShardCtx,
                    adam_cfg: Optional[adam.AdamConfig] = None, *,
                    schedule: Optional[Callable] = None):
    """Returns ``(train_step, acfg)``; ``acfg`` defaults to AdamW with
    moments in ``cfg.opt_state_dtype``.

    ``train_step(model, opt_state, batch)`` takes the gradients of the
    family's ``train_loss`` over ``list(model.parameters())`` and runs
    ``adam.step`` on them, in place; it returns ``(model, opt_state,
    {'loss', 'grad_norm'})``, both device tensors (no host sync).  The
    model's own config (``model.cfg``) decides its forward, its remat and
    its loss; ``cfg`` chooses the family and the default Adam config.
    ``schedule`` maps ``opt_state.step``, read before the step's increment
    as the JAX trainer reads it, to the learning-rate scale (1.0
    without)."""
    mod = module_for(cfg)
    acfg = adam_cfg or adam.AdamConfig(
        state_dtype=getattr(torch, cfg.opt_state_dtype))

    def train_step(model, opt_state: adam.AdamState, batch: dict):
        params = list(model.parameters())
        loss = mod.train_loss(model, batch, model.cfg, ctx)
        grads = torch.autograd.grad(loss, params)
        lr_scale = 1.0 if schedule is None else schedule(opt_state.step)
        _, opt_state, gnorm = adam.step(params, grads, opt_state, acfg,
                                        lr_scale)
        return model, opt_state, {'loss': loss.detach(), 'grad_norm': gnorm}

    return train_step, acfg


def make_prefill(cfg: ModelConfig, ctx: ShardCtx):
    """``prefill(params, batch)`` -> the logits of the last position [B,
    V]; ``batch`` holds ``tokens`` [B, S], and ``frames`` [B, S_enc, D]
    for ``encdec``."""
    if cfg.family in ('dense', 'vlm'):
        def prefill(params, batch):
            lg, _ = params.prefill(batch['tokens'])
            return lg
        return prefill

    @torch.no_grad()
    def prefill(params, batch):
        if cfg.family == 'encdec':
            h = params.decode_train(batch['tokens'],
                                    params.encode(batch['frames']))
        elif cfg.family == 'moe':
            h, _ = params(batch['tokens'])
        else:
            h = params(batch['tokens'])
        return params.logits(h[:, -1:])[:, 0]
    return prefill


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx):
    """``step(params, token, state, pos)`` -> (logits [B, V], state)."""
    if cfg.family == 'encdec':
        def step(params, token, state, pos: int):
            lg, caches = params.decode_step(token, state['self'],
                                            state['cross'], pos)
            return lg, dict(state, self=caches)
        return step

    def step(params, token, state, pos: int):
        return params.decode_step(token, state, pos)
    return step


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      tp: int = 1, *, device=None):
    """The zeroed decode state of ``batch`` rows of ``max_seq`` positions.
    For ``encdec`` it is ``{'self': K/V pair, 'cross': K/V pair}``, the
    cross pair zeros of the self pair's shape, as in the JAX package
    (``whisper.prepare_cross`` fills it from frames)."""
    dev = resolve_device(device)
    if cfg.family == 'encdec':
        return {'self': whisper.init_kv_cache(cfg, batch, max_seq, tp,
                                              device=dev),
                'cross': whisper.init_kv_cache(cfg, batch, max_seq, tp,
                                               device=dev)}
    if cfg.family == 'ssm':
        return xlstm.init_state(cfg, batch, device=dev)
    if cfg.family == 'hybrid':
        return zamba2.init_state(cfg, batch, max_seq, tp, device=dev)
    return module_for(cfg).init_kv_cache(cfg, batch, max_seq, tp, device=dev)
