"""Architecture registry: one interface over the model families, for
serving.

Per config: ``init_params`` (random weights from a seeded generator),
``make_ctx`` / ``tp_of``, and the serving entry points ``make_prefill``,
``make_decode_step`` and ``init_decode_state``.  The ``dense`` and ``vlm``
families (chameleon's backbone is dense with qk-norm) are ported; the
others raise ``NotImplementedError`` and never fall back to another family.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..runtime.sharding import ShardCtx
from . import transformer

_FAMILY = {
    'dense': transformer,
    'vlm': transformer,      # chameleon backbone == dense + qk_norm
}

_UNPORTED = ('moe', 'encdec', 'ssm', 'hybrid')


def module_for(cfg: ModelConfig):
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f'{cfg.name}: the {cfg.family!r} family is not ported yet '
            '(ROADMAP queue 1, item 3b)')
    return _FAMILY[cfg.family]


def init_params(seed: int, cfg: ModelConfig, tp: int = 1, *, device=None):
    """The model with random weights from a generator seeded ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    mod = module_for(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return mod.init_params(gen, cfg, tp)


def make_ctx(mesh, cfg: ModelConfig) -> ShardCtx:
    return ShardCtx(recipe=cfg.recipe, tp=tp_of(mesh, cfg))


def tp_of(mesh, cfg: ModelConfig) -> int:
    if mesh is not None:
        raise NotImplementedError('the port has no device mesh yet '
                                  '(ROADMAP queue 1, item 3c)')
    return 1


def make_prefill(cfg: ModelConfig, ctx: ShardCtx):
    module_for(cfg)

    def prefill(params, batch):
        lg, _ = params.prefill(batch['tokens'])
        return lg
    return prefill


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx):
    module_for(cfg)

    def step(params, token, state, pos: int):
        return params.decode_step(token, state, pos)
    return step


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      tp: int = 1, *, device=None):
    return module_for(cfg).init_kv_cache(cfg, batch, max_seq, tp,
                                         device=resolve_device(device))
