"""The port's side of the partitioned recurrent tests
(``tests/test_torch_mesh_ssm.py``): the function each rank of a 4-rank
gloo group runs (``torch_mesh_ranks.spawn``), importing no JAX.

``ssm_rank`` starts from the oracle's weights (``interop.
lm_params_on_mesh``), batches and tokens, laid out on (data 2, model 2) by
``registry.shard_step_inputs`` and ``shard_decode_inputs``, and runs what
the oracle runs: the prefill, the train step and the decode at each
position from a zeroed state; beside them, the same weights'
unpartitioned loss on the first batch.
"""
from __future__ import annotations

import numpy as np
import torch

from jax_ssm_oracle import (ARCHS, DECODE_BATCH, LR, MAX_SEQ, POSITIONS,
                            STEPS, WARMUP)
from torch_mesh_ranks import load, tensors


def _batch(arrays: dict, arch: str, i: int) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            tensors(arrays, f'{arch}/batch{i}', np.asarray).items()}


def _tokens(arrays: dict, key: str) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key]))


def flat(tree, prefix: str = '') -> dict:
    """A nested dict of tensors as ``{'a/b': tensor}``."""
    out = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _train(cfg, mesh, arrays: dict, arch: str, model, plain,
           prefill: dict = None) -> dict:
    """The prefill's logits (gathered), each step's loss and gradient norm
    (the replicated values, and their placements), every parameter's and
    moment's local block shape, the trained state gathered, and the
    unpartitioned loss of the first batch.  ``prefill``: the prefill's
    batch (default: the oracle's ``prefill_tokens``)."""
    from repro_torch.models import registry
    from repro_torch.optim import adam, schedule
    ctx = registry.make_ctx(mesh, cfg)
    _, _, pf = registry.shard_step_inputs(
        cfg, mesh, None, batch=prefill or {'tokens': _tokens(
            arrays, f'{arch}/prefill_tokens')})
    logits = registry.make_prefill(cfg, ctx)(model, pf)

    step, acfg = registry.make_train_step(
        cfg, ctx, adam.AdamConfig(lr=LR, state_dtype=getattr(
            torch, cfg.opt_state_dtype)), schedule=lambda s:
        schedule.linear_warmup_cosine(s, warmup_steps=WARMUP,
                                      total_steps=STEPS))
    opt = adam.init(list(model.parameters()), acfg)
    rec = {'logits': logits.full_tensor(),
           'logits_placements': [str(p) for p in logits.placements],
           'plain_loss': float(registry.module_for(cfg).train_loss(
               plain, _batch(arrays, arch, 0), cfg).detach()),
           'loss': [], 'grad_norm': [], 'metric_placements': []}
    for i in range(STEPS):
        _, _, batch = registry.shard_step_inputs(
            cfg, mesh, None, batch=_batch(arrays, arch, i))
        model, opt, m = step(model, opt, batch)
        rec['loss'].append(float(m['loss'].full_tensor()))
        rec['grad_norm'].append(float(m['grad_norm'].full_tensor()))
        rec['metric_placements'].append(
            [str(p) for v in m.values() for p in v.placements])
    named = dict(model.named_parameters())
    rec['local'] = {n: tuple(p.to_local().shape) for n, p in named.items()}
    rec['moment_local'] = [(tuple(m.to_local().shape),
                            tuple(v.to_local().shape))
                           for m, v in zip(opt.mu, opt.nu)]
    rec['step'] = (int(opt.step.full_tensor()),
                   [str(p) for p in opt.step.placements])
    rec['params'] = {n: p.detach().full_tensor() for n, p in named.items()}
    rec['mu'] = [m.full_tensor() for m in opt.mu]
    rec['nu'] = [v.full_tensor() for v in opt.nu]
    return rec


def _decode(cfg, mesh, arrays: dict, arch: str, model) -> dict:
    """Each step's logits (gathered; their placements once), the state's
    leaves gathered, their local block shapes and placements, whether
    every leaf is a DTensor, this rank's [start, stop) of the caches'
    sequence (zamba2) and per step whether its blocks of the caches
    changed, and whether the step returned the state it was given."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import registry
    from repro_torch.runtime.sharding import local_range, to_replicated
    state = registry.init_decode_state(cfg, DECODE_BATCH, MAX_SEQ,
                                       registry.tp_of(mesh, cfg),
                                       device='cpu')
    _, state, _ = registry.shard_decode_inputs(cfg, mesh, state=state)
    leaves = flat(state)
    caches = [leaves[k] for k in ('kv_k', 'kv_v') if k in leaves]
    step = registry.make_decode_step(cfg, registry.make_ctx(mesh, cfg))
    logits, changed, same = [], [], True
    for tok, pos in zip(arrays[f'{arch}/decode_tokens'], POSITIONS):
        _, _, tok = registry.shard_decode_inputs(
            cfg, mesh, token=torch.from_numpy(np.array(tok)))
        before = [c.to_local().clone() for c in caches]
        lg, out = step(model, tok, state, pos)
        same &= out is state
        changed.append([not torch.equal(b, c.to_local())
                        for b, c in zip(before, caches)])
        logits.append(to_replicated(lg))
    return {'decode_logits': torch.stack([lg.to_local() for lg in logits]),
            'decode_placements': [str(p) for p in logits[0].placements],
            'state': {k: v.full_tensor() for k, v in leaves.items()},
            'state_local': {k: tuple(v.to_local().shape)
                            for k, v in leaves.items()},
            'state_placements': {k: [str(p) for p in v.placements]
                                 for k, v in leaves.items()},
            'state_dtensor': all(isinstance(v, DTensor)
                                 for v in leaves.values()),
            'seq_range': local_range(caches[0], 2) if caches else None,
            'changed': changed, 'same_state': same}


def ssm_rank(rank: int, npz_path: str, archs: tuple) -> dict:
    """Per arch, on (data 2, model 2): ``_train``'s and ``_decode``'s
    records."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced(**ARCHS[arch])
        p0 = tensors(arrays, f'{arch}/p0', np.asarray)
        plain = interop.lm_params_from_numpy(p0, cfg, device='cpu')
        rec = _train(cfg, mesh, arrays, arch,
                     interop.lm_params_on_mesh(p0, cfg, mesh, device='cpu'),
                     plain)
        rec.update(_decode(cfg, mesh, arrays, arch, interop.lm_params_on_mesh(
            p0, cfg, mesh, device='cpu')))
        out[arch] = rec
    return out
