"""The port's side of the partitioned parity tests
(``tests/test_torch_mesh_tp.py``): the function each rank of a 4-rank gloo
group runs (``torch_mesh_ranks.spawn``), importing no JAX.

``tp_rank`` starts from the oracle's weights (``interop.
lm_params_on_mesh``) and batches, laid out on (data 2, model 2) by
``registry.shard_step_inputs``, and runs the prefill and the train step
as the oracle does; beside them, the same weights' unpartitioned loss on
the first batch.
"""
from __future__ import annotations

import numpy as np
import torch

from jax_tp_oracle import ARCHS, LR, STEPS, WARMUP
from torch_mesh_ranks import load, tensors


def _batch(arrays: dict, arch: str, i: int) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            tensors(arrays, f'{arch}/batch{i}', np.asarray).items()}


def tp_rank(rank: int, npz_path: str, archs: tuple) -> dict:
    """Per arch: the prefill's logits (gathered), each step's loss and
    gradient norm (the replicated values, and their placements), every
    parameter's and moment's local block shape, the trained parameters
    gathered, and the unpartitioned loss."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adam, schedule
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced(**ARCHS[arch])
        ctx = registry.make_ctx(mesh, cfg)
        p0 = tensors(arrays, f'{arch}/p0', np.asarray)
        model = interop.lm_params_on_mesh(p0, cfg, mesh, device='cpu')
        plain = interop.lm_params_from_numpy(p0, cfg, device='cpu')

        _, _, pf = registry.shard_step_inputs(cfg, mesh, None,
                                              batch=_batch(arrays, arch,
                                                           STEPS))
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
        rec['local'] = {n: tuple(p.to_local().shape)
                        for n, p in named.items()}
        rec['moment_local'] = [(tuple(m.to_local().shape),
                                tuple(v.to_local().shape))
                               for m, v in zip(opt.mu, opt.nu)]
        rec['step'] = (int(opt.step.full_tensor()),
                       [str(p) for p in opt.step.placements])
        rec['params'] = {n: p.detach().full_tensor()
                         for n, p in named.items()}
        rec['mu'] = [m.full_tensor() for m in opt.mu]
        rec['nu'] = [v.full_tensor() for v in opt.nu]
        out[arch] = rec
    return out
