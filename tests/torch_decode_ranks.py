"""The port's side of the partitioned decode tests
(``tests/test_torch_mesh_decode.py``): the function each rank of a 4-rank
gloo group runs (``torch_mesh_ranks.spawn``), importing no JAX.

``decode_rank`` starts from the oracle's weights (``interop.
lm_params_on_mesh``) and zeroed caches, laid out on (data 2, model 2) by
``registry.shard_decode_inputs``, and steps the decode at the oracle's
positions on its tokens; beside it, the same weights' unpartitioned port
on the same tokens, and the layout on (data 4, model 1), where each rank
holds its row's whole sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from jax_decode_oracle import BATCH, MAX_SEQ, POSITIONS
from torch_mesh_ranks import load, tensors


def _steps(cfg, mesh, model, toks) -> tuple:
    """The decode at each of ``POSITIONS`` on ``mesh`` (None: plainly) from
    zeroed caches: each step's logits whole, the caches, and per step
    whether this rank's blocks of the caches changed."""
    from repro_torch.models import registry
    from repro_torch.runtime.sharding import to_replicated
    state = registry.init_decode_state(cfg, BATCH, MAX_SEQ,
                                       registry.tp_of(mesh, cfg),
                                       device='cpu')
    if mesh is not None:
        _, state, _ = registry.shard_decode_inputs(cfg, mesh, state=state)
    step = registry.make_decode_step(cfg, registry.make_ctx(mesh, cfg))
    logits, changed, same_state = [], [], True

    def local(t):
        return t.to_local() if mesh is not None else t

    for tok, pos in zip(toks, POSITIONS):
        tok = torch.from_numpy(np.array(tok))
        if mesh is not None:
            _, _, tok = registry.shard_decode_inputs(cfg, mesh, token=tok)
        before = [local(c).clone() for c in state]
        lg, out = step(model, tok, state, pos)
        same_state &= out is state
        changed.append([not torch.equal(b, local(c))
                        for b, c in zip(before, state)])
        logits.append(to_replicated(lg))
    return logits, state, changed, same_state


def decode_rank(rank: int, npz_path: str, archs: tuple) -> dict:
    """Per arch, on (data 2, model 2): each step's logits (gathered; their
    placements once replicated), the caches gathered, each cache's local
    block shape and this rank's [start, stop) of the sequence, per step
    whether this rank's blocks changed, whether the step returned the state
    it was given; the unpartitioned port's logits; on (data 4, model 1)
    each step's logits."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.sharding import local_range
    arrays = load(npz_path)
    meshes = {'2x2': make_test_mesh((2, 2), device='cpu'),
              '4x1': make_test_mesh((4, 1), device='cpu')}
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        p0 = tensors(arrays, f'{arch}/p0', np.asarray)
        toks = arrays[f'{arch}/tokens']
        model = interop.lm_params_on_mesh(p0, cfg, meshes['2x2'],
                                          device='cpu')
        logits, state, changed, same = _steps(cfg, meshes['2x2'], model, toks)
        plain = interop.lm_params_from_numpy(p0, cfg, device='cpu')
        whole = interop.lm_params_on_mesh(p0, cfg, meshes['4x1'],
                                          device='cpu')
        out[arch] = {
            'logits': torch.stack([lg.to_local() for lg in logits]),
            'logits_placements': [str(p) for p in logits[0].placements],
            'caches': [c.full_tensor() for c in state],
            'local': [tuple(c.to_local().shape) for c in state],
            'cache_placements': [str(p) for p in state[0].placements],
            'seq_range': local_range(state[0], 2),
            'changed': changed, 'same_state': same,
            'plain_logits': torch.stack(_steps(cfg, None, plain, toks)[0]),
            'whole_seq_logits': torch.stack(
                [lg.to_local() for lg in _steps(cfg, meshes['4x1'], whole,
                                                toks)[0]])}
    return out
