"""Architecture registry: one interface over the model families, for
training and serving.

Per config: ``init_params`` (random weights from a seeded generator) and
``abstract_params`` (the same tree on the ``meta`` device, no values),
``make_ctx`` / ``tp_of`` for a device mesh, the train step
``make_train_step`` (the family's ``train_loss``, its gradients by
autograd, and ``optim.adam.step``), the serving entry points
``make_prefill``, ``make_decode_step`` and ``init_decode_state``
(``abstract_decode_state`` on ``meta``), the dry run's ``input_specs``,
with the JAX package's branch for each family: ``dense`` and ``vlm``
(chameleon's backbone is dense with qk-norm), ``moe``, ``encdec``
(whisper), ``ssm`` (xlstm) and ``hybrid`` (zamba2); and the recipe's
partition specs:
``param_specs`` (by ``named_parameters`` name), ``batch_shardings`` and
``decode_state_specs``.  ``shard_step_inputs`` lays out a model's
parameters, its Adam state and a batch as DTensors by those specs, and
``shard_decode_inputs`` the parameters, the decode state and the token,
as the JAX package's dry run gives them to ``jax.jit`` as
``in_shardings``; the train, prefill and decode steps of every family
run partitioned on such a layout (moe's under the recipe ``ep``: the
experts over ``model`` and their rows over ``data``, the dense
submodules by the ``tp`` table; xlstm's and zamba2's under ``ssm``: the
``tp`` table, the recurrent states by ``decode_state_specs``, at
``long_500k`` zamba2's caches by its long-context rule; whisper's under
``dp``: the parameters replicated, the self and cross K/V pairs by the
dense rule), and as before on plain tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..configs.base import LONG_CONTEXT_FAMILIES, ModelConfig, ShapeConfig
from ..device import resolve_device
from ..optim import adam
from ..runtime.sharding import (P, ShardCtx, adaptive_spec, all_axes,
                                axes_size, batch_axes, distribute_like,
                                distribute_tree, mesh_axes,
                                spec_to_placements, to_replicated,
                                unshard_dims)
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


class _MetaDraws:
    """Stands for a generator on the ``meta`` device: ``layers.normal``
    makes tensors of the right shape and dtype with no values."""

    device = torch.device('meta')


def abstract_params(cfg: ModelConfig, tp: int = 1):
    """The model of ``init_params`` on the ``meta`` device: every shape and
    dtype, no storage (maverick's ~400B parameters allocate nothing)."""
    return module_for(cfg).init_params(_MetaDraws(), cfg, tp)


def make_ctx(mesh, cfg: ModelConfig, *, long_context: bool = False
             ) -> ShardCtx:
    return ShardCtx(mesh=mesh, recipe=cfg.recipe, tp=tp_of(mesh, cfg),
                    seq_shard_kv=long_context)


def tp_of(mesh, cfg: ModelConfig) -> int:
    """The mesh's ``model`` size (1 without a mesh): every recipe pads q
    heads to it."""
    return mesh_axes(mesh).get('model', 1)


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
            lg, _ = params.prefill(batch['tokens'], ctx)
            return to_replicated(lg)
        return prefill

    @torch.no_grad()
    def prefill(params, batch):
        if cfg.family == 'encdec':
            h = params.decode_train(batch['tokens'],
                                    params.encode(batch['frames'], ctx), ctx)
        elif cfg.family == 'moe':
            h, _ = params(batch['tokens'], ctx)
        else:
            h = params(batch['tokens'], ctx)
        # the sequence gathered whole before the last position is sliced
        last = unshard_dims(h, (1,))[:, -1:]
        return to_replicated(params.logits(last, ctx)[:, 0])
    return prefill


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx):
    """``step(params, token, state, pos)`` -> (logits [B, V], state)."""
    if cfg.family == 'encdec':
        def step(params, token, state, pos: int):
            lg, caches = params.decode_step(token, state['self'],
                                            state['cross'], pos, ctx)
            return lg, dict(state, self=caches)
        return step

    def step(params, token, state, pos: int):
        return params.decode_step(token, state, pos, ctx)
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


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                          tp: int = 1):
    """``init_decode_state``'s tree on the ``meta`` device: every shape and
    dtype, no storage."""
    return init_decode_state(cfg, batch, max_seq, tp, device='meta')


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The dry run's inputs of ``shape`` on the ``meta`` device: int32
    ``tokens`` and ``labels`` [B, S] to train, ``tokens`` to prefill (with
    ``frames`` [B, S, D] in ``cfg.dtype`` for ``encdec``), one ``token``
    [B, 1] to decode against a cache of length S."""
    b, s = shape.global_batch, shape.seq_len

    def tok(n):
        return torch.empty((b, n), dtype=torch.int32, device='meta')

    if shape.kind == 'decode':
        return {'token': tok(1)}
    batch = {'tokens': tok(s)}
    if shape.kind == 'train':
        batch['labels'] = tok(s)
    if cfg.family == 'encdec':
        batch['frames'] = torch.empty((b, s, cfg.d_model),
                                      dtype=getattr(torch, cfg.dtype),
                                      device='meta')
    return batch


# ---------------------------------------------------------------------------
# Partition specs (recipe rules, by parameter name and rank)
# ---------------------------------------------------------------------------

_TP_LAST2 = {
    'wq': ('data', 'model'), 'w_up': ('data', 'model'),
    'w_gate': ('data', 'model'), 'w_in': ('data', 'model'),
    'w_x': ('data', 'model'), 'w_h': ('data', 'model'),
    'wk': ('data', None), 'wv': ('data', None), 'w_if': ('data', None),
    'wo': ('model', 'data'), 'w_down': ('model', 'data'),
    'w_out': ('model', 'data'),
    # embed shards d_model, not vocab: a vocab-sharded table turns every
    # token lookup into a full-table all-gather
    'embed': (None, 'model'), 'unembed': (None, 'model'),
    'router': (None, None), 'frontend_proj': (None, None),
    'conv': (None, None),
}
_EXPERT_LAST3 = {
    'w_up': ('model', 'data', None), 'w_gate': ('model', 'data', None),
    'w_down': ('model', None, 'data'),
}


def _guard_divisible(spec: P, shape, mesh) -> P:
    """Drop spec axes whose size does not divide the tensor dimension."""
    if mesh is None:
        return spec
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        size = axes_size(mesh, entry)
        out.append(entry if size and shape[i] % size == 0 else None)
    return P(*out)


def _leaf_spec(path: tuple, leaf, recipe: str, mesh=None) -> P:
    """The spec of the parameter at ``path`` (its name's parts, layer
    indices included).  A parameter of the port is one layer's slice of the
    JAX package's stacked leaf, so its spec is that leaf's spec less the
    leading stacked dims (always replicated)."""
    # 'dp' replicates params; 'ssm' follows the 'tp' table
    if recipe == 'dp':
        return P()
    if recipe == 'fsdp':
        # ZeRO-3: every weight's largest trailing dim over every axis
        return adaptive_spec(leaf.shape, mesh,
                             [(-2, ('data', 'model')),
                              (-1, ('data', 'model'))]) if mesh else P()
    keys = [k for k in path if not str(k).isdigit()]
    name = keys[-1] if keys else None
    nd = len(leaf.shape)
    in_moe, in_shared = 'moe' in keys, 'shared' in keys
    if in_moe and not in_shared and name in _EXPERT_LAST3 and nd >= 3:
        spec = P(*((None,) * (nd - 3) + _EXPERT_LAST3[name]))
    elif name in _TP_LAST2 and nd >= 2:
        spec = P(*((None,) * (nd - 2) + _TP_LAST2[name]))
    else:
        spec = P(*((None,) * nd))
    return _guard_divisible(spec, leaf.shape, mesh)


def param_specs(cfg: ModelConfig, params, mesh=None) -> dict:
    """``{name: spec}`` for every parameter of ``params`` (a model, or a
    dict of tensors by ``named_parameters`` name) under the config's
    recipe."""
    named = (params.named_parameters() if hasattr(params, 'named_parameters')
             else params.items())
    return {name: _leaf_spec(tuple(name.split('.')), leaf, cfg.recipe, mesh)
            for name, leaf in named}


def _is_shaped(x) -> bool:
    return hasattr(x, 'shape') and not isinstance(x, (dict, list, tuple))


def _map_with_path(fn, tree, path: tuple = ()):
    """``tree`` (dicts, lists, tuples) with each shaped leaf ``x`` at the
    keys ``path`` replaced by ``fn(path, x)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shaped(tree):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_shardings(cfg: ModelConfig, mesh, batch_tree) -> Any:
    """Input-batch specs: batch dim over pod x data, sequence over 'model'
    where divisible; recipe 'fsdp' shards batch over every axis."""
    baxes = all_axes(mesh) if cfg.recipe == 'fsdp' else batch_axes(mesh)

    def rule(_, leaf):
        if mesh is None:
            return P()
        return adaptive_spec(leaf.shape, mesh, [(0, baxes), (1, 'model')])

    return _map_with_path(rule, batch_tree)


def _unflatten(named) -> dict:
    """``(name, tensor)`` pairs of ``named_parameters`` as the nested tree
    a family's model is built from: a dotted part that is a number indexes
    a list (``blocks.0.attn.wq`` is ``tree['blocks'][0]['attn']['wq']``)."""
    tree: dict = {}
    for name, t in named:
        *path, leaf = name.split('.')
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(tree)


def shard_step_inputs(cfg: ModelConfig, mesh, params, opt_state=None,
                      batch=None):
    """The step's inputs laid out on ``mesh`` as DTensors, the JAX
    package's ``in_shardings``: the model ``params`` (a new model of the
    same family, each parameter by ``param_specs``), its Adam state
    (each moment as its parameter, the step count replicated) and a batch
    (``batch_shardings``); ``None`` passes through.  Each rank holds the
    whole values (the same seed or weights on every rank) and keeps its
    own block.  Returns ``(params, opt_state, batch)``."""
    if params is not None:
        specs = param_specs(cfg, params, mesh)
        named = list(params.named_parameters())
        placed = [(n, distribute_like(p, mesh,
                                      spec_to_placements(specs[n], mesh)))
                  for n, p in named]
        if opt_state is not None:
            pl = [t.placements for _, t in placed]
            opt_state = adam.AdamState(
                step=distribute_like(opt_state.step, mesh,
                                     spec_to_placements(P(), mesh)),
                mu=tuple(distribute_like(m, mesh, q)
                         for m, q in zip(opt_state.mu, pl)),
                nu=tuple(distribute_like(v, mesh, q)
                         for v, q in zip(opt_state.nu, pl)))
        params = type(params)(params.cfg, _unflatten(placed))
    elif opt_state is not None:
        raise ValueError('the Adam state is laid out by its parameters')
    if batch is not None:
        batch = distribute_tree(batch, batch_shardings(cfg, mesh, batch),
                                mesh)
    return params, opt_state, batch


def shard_decode_inputs(cfg: ModelConfig, mesh, params=None, state=None,
                        token=None, *, long_context: bool = False):
    """The decode step's inputs laid out on ``mesh`` as DTensors, the JAX
    package's ``in_shardings`` for it: the model ``params`` as
    ``shard_step_inputs`` lays it out, the decode state by
    ``decode_state_specs``, the token [B, 1] by ``batch_shardings``;
    ``None`` passes through.  ``pos`` stays a Python int (JAX's
    replicated scalar).  Each rank holds the whole values and keeps its
    own block, in storage of its own.  The dense, vlm and moe decode steps
    run on this layout (the stacked K/V caches [L, B, T, Hkv, hd], moe's
    [n_super, n_attn, B, T, Hkv, hd]: batch over pod x data, sequence over
    'model'), and so do the ssm, hybrid and encdec ones (xlstm's
    ``{'mlstm', 'slstm_h', 'slstm_c'}``: batch, then heads, else dk, over
    'model', the sLSTM's di; zamba2's ``{'ssm': {'ssm', 'conv'}, 'kv_k',
    'kv_v'}``: the SSD state's heads, the conv window's channels, the
    caches' sequence; whisper's ``{'self', 'cross'}`` K/V pairs as the
    dense caches).  ``long_context`` (the ``long_500k`` cells, families
    of ``LONG_CONTEXT_FAMILIES`` only, else it raises) lays the caches out
    by the long-context rule: the sequence over 'data', the heads, else
    head_dim, over 'model'.  Returns ``(params, state, token)``."""
    if long_context and cfg.family not in LONG_CONTEXT_FAMILIES:
        raise ValueError(f'{cfg.name}: the long-context layout is for the '
                         f'{" and ".join(LONG_CONTEXT_FAMILIES)} families, '
                         f'not {cfg.family}')
    if params is not None:
        params = shard_step_inputs(cfg, mesh, params)[0]
    if state is not None:
        state = distribute_tree(state, decode_state_specs(
            cfg, state, mesh, long_context=long_context), mesh)
    if token is not None:
        token = distribute_tree(token, batch_shardings(cfg, mesh, token),
                                mesh)
    return params, state, token


def decode_state_specs(cfg: ModelConfig, state_tree, mesh, *,
                       long_context: bool):
    """KV caches: batch over pod x data, sequence over 'model'; long
    context (batch 1): sequence over 'data', heads (else head_dim) over
    'model'.  Recurrent states: batch and the largest inner dim."""
    baxes = batch_axes(mesh)

    def rule(names, leaf):
        if mesh is None:
            return P()
        shape = tuple(leaf.shape)
        nd = len(shape)
        if cfg.family == 'ssm':
            if 'mlstm' in names:   # [ns, se-1, B, H, dk, dv]
                return adaptive_spec(shape, mesh,
                                     [(2, baxes), (3, 'model'), (4, 'model')])
            return adaptive_spec(shape, mesh,  # slstm [ns, B, di]
                                 [(1, baxes), (2, 'model')])
        if cfg.family == 'hybrid':
            if 'kv_k' in names or 'kv_v' in names:   # [pts, B, T, H, hd]
                if long_context:
                    return adaptive_spec(shape, mesh,
                                         [(2, 'data'), (3, 'model'),
                                          (4, 'model')])
                return adaptive_spec(shape, mesh, [(1, baxes), (2, 'model')])
            # mamba states: ssm [L,B,h,ds,hd] / conv [L,B,K-1,C]
            return adaptive_spec(shape, mesh,
                                 [(1, baxes), (2, 'model'), (-1, 'model')])
        # dense/moe/encdec stacked caches [L(,A),B,T,Hkv,hd]
        lead = nd - 4
        if long_context:
            return adaptive_spec(shape, mesh,
                                 [(lead + 1, 'data'), (lead + 2, 'model'),
                                  (lead + 3, 'model')])
        return adaptive_spec(shape, mesh,
                             [(lead, baxes), (lead + 1, 'model')])

    return _map_with_path(rule, state_tree)
