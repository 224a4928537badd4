"""The port's side of the partitioned encoder-decoder tests
(``tests/test_torch_mesh_encdec.py``): the function each rank of a 4-rank
gloo group runs (``torch_mesh_ranks.spawn``), importing no JAX.

``encdec_rank`` starts from the oracle's weights (``interop.
lm_params_on_mesh``), batches, frames and tokens, laid out on (data 2,
model 2) by ``registry.shard_step_inputs`` and ``shard_decode_inputs``,
and runs what the oracle runs: the prefill, the train steps
(``torch_ssm_ranks._train``), ``prepare_cross`` of the decode frames, and
the decode at each position from zeroed self-attention caches and that
cross pair; beside them the same weights' unpartitioned loss and decode.
"""
from __future__ import annotations

import numpy as np
import torch

from jax_encdec_oracle import ARCH, CASES, DECODE_BATCH, MAX_SEQ, POSITIONS
from torch_mesh_ranks import load, tensors
from torch_ssm_ranks import _train


def _decode(cfg, mesh, model, plain, arrays: dict, case: str) -> dict:
    """``prepare_cross`` of the decode frames on the mesh (gathered, and
    its placements), then the decode steps on the mesh and plainly from
    the same state: each step's logits (gathered; their placements once),
    the state's leaves gathered, their local block shapes and placements,
    this rank's [start, stop) of the caches' sequence, per step whether
    its blocks of the self-attention caches changed, whether the step
    returned the state it was given."""
    from repro_torch.models import registry
    from repro_torch.runtime.sharding import local_range, to_replicated
    ctx = registry.make_ctx(mesh, cfg)
    frames = torch.from_numpy(np.array(arrays[f'{case}/decode_frames']))
    _, _, laid = registry.shard_step_inputs(cfg, mesh, None,
                                            batch={'frames': frames})
    cross = model.prepare_cross(laid['frames'], ctx)
    whole = tuple(c.full_tensor() for c in cross)
    rec = {'cross': whole,
           'cross_placements': [str(p) for p in cross[0].placements]}

    def zeroed():
        state = registry.init_decode_state(cfg, DECODE_BATCH, MAX_SEQ,
                                           registry.tp_of(mesh, cfg),
                                           device='cpu')
        return dict(state, cross=tuple(c.clone() for c in whole))

    _, state, _ = registry.shard_decode_inputs(cfg, mesh, state=zeroed())
    step = registry.make_decode_step(cfg, ctx)
    plain_state = zeroed()
    plain_step = registry.make_decode_step(cfg, registry.make_ctx(None, cfg))
    logits, plain_logits, changed, same = [], [], [], True
    for tok, pos in zip(arrays[f'{case}/decode_tokens'], POSITIONS):
        tok = torch.from_numpy(np.array(tok))
        _, _, dtok = registry.shard_decode_inputs(cfg, mesh, token=tok)
        before = [c.to_local().clone() for c in state['self']]
        lg, out = step(model, dtok, state, pos)
        same &= out['self'] is state['self']
        changed.append([not torch.equal(b, c.to_local())
                        for b, c in zip(before, state['self'])])
        logits.append(to_replicated(lg))
        plain_logits.append(plain_step(plain, tok, plain_state, pos)[0])
    leaves = {f'{k}/{i}': t for k in ('self', 'cross')
              for i, t in enumerate(state[k])}
    rec.update({
        'decode_logits': torch.stack([lg.to_local() for lg in logits]),
        'decode_placements': [str(p) for p in logits[0].placements],
        'plain_decode_logits': torch.stack(plain_logits),
        'state': {k: v.full_tensor() for k, v in leaves.items()},
        'state_local': {k: tuple(v.to_local().shape)
                        for k, v in leaves.items()},
        'state_placements': {k: [str(p) for p in v.placements]
                             for k, v in leaves.items()},
        'seq_range': local_range(state['self'][0], 2),
        'changed': changed, 'same_state': same})
    return rec


def encdec_rank(rank: int, npz_path: str, cases: tuple) -> dict:
    """Per case, on (data 2, model 2): ``torch_ssm_ranks._train``'s
    records (the prefill on the oracle's tokens and frames) and
    ``_decode``'s."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')
    out = {}
    for case in cases:
        cfg = get_config(ARCH).reduced(**CASES[case])
        p0 = tensors(arrays, f'{case}/p0', np.asarray)
        plain = interop.lm_params_from_numpy(p0, cfg, device='cpu')
        rec = _train(cfg, mesh, arrays, case, interop.lm_params_on_mesh(
            p0, cfg, mesh, device='cpu'), plain,
            prefill=tensors(arrays, f'{case}/prefill'))
        rec.update(_decode(cfg, mesh, interop.lm_params_on_mesh(
            p0, cfg, mesh, device='cpu'), plain, arrays, case))
        out[case] = rec
    return out

