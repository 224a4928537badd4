"""The port's side of the long-context decode tests
(``tests/test_torch_mesh_long.py``): the function each rank of a 4-rank
gloo group runs (``torch_mesh_ranks.spawn``), importing no JAX.

``long_rank`` starts from the oracle's weights (``interop.
lm_params_on_mesh``) and a zeroed state at batch 1, laid out on (data 2,
model 2) by ``registry.shard_decode_inputs(long_context=True)``, and
steps the decode (``make_ctx(long_context=True)``) at the oracle's
positions on its tokens; beside it the same weights' unpartitioned
decode.  ``repeat_kv_rank`` checks ``layers.repeat_kv`` on kv heads split
over ``model``, against the plain gather.
"""
from __future__ import annotations

import numpy as np
import torch

from jax_long_oracle import BATCH, CASES, MAX_SEQ, POSITIONS
from torch_mesh_ranks import load, tensors
from torch_ssm_ranks import flat


def _repeat_kv(mesh) -> dict:
    """``repeat_kv`` of a [1, 4, Hkv, 8] tensor with its heads over
    ``model`` (the sequence over ``data``) for (Hkv, Hp, n_heads) maps
    that keep each rank's q heads in its block of kv heads (a GQA map, the
    identity) and one that does not (a padded head clamped across the
    block): the result gathered, its placements, and whether it equals the
    plain gather."""
    from torch.distributed.tensor import Shard
    from repro_torch.models import layers
    from repro_torch.runtime.sharding import distribute_like
    k = torch.arange(4 * 4 * 8, dtype=torch.float32).reshape(1, 4, 4, 8)
    out = {}
    for hkv, hp, n in ((2, 4, 4), (4, 4, 4), (2, 4, 2)):
        x = k[:, :, :hkv]
        got = layers.repeat_kv(distribute_like(x, mesh, [Shard(1), Shard(2)]),
                               hp, n)
        out[(hkv, hp, n)] = {
            'equal': torch.equal(got.full_tensor(), layers.repeat_kv(x, hp,
                                                                     n)),
            'placements': [str(p) for p in got.placements]}
    return out


def _steps(cfg, mesh, model, toks) -> tuple:
    """The decode at each of ``POSITIONS`` on ``mesh`` (None: plainly)
    from a zeroed state: each step's logits whole, the state, and per step
    whether this rank's blocks of the K/V caches changed."""
    from repro_torch.models import registry
    from repro_torch.runtime.sharding import to_replicated
    state = registry.init_decode_state(cfg, BATCH, MAX_SEQ,
                                       registry.tp_of(mesh, cfg),
                                       device='cpu')
    if mesh is not None:
        _, state, _ = registry.shard_decode_inputs(cfg, mesh, state=state,
                                                   long_context=True)
    step = registry.make_decode_step(cfg, registry.make_ctx(
        mesh, cfg, long_context=mesh is not None))
    caches = [state[k] for k in ('kv_k', 'kv_v') if k in state]
    logits, changed, same = [], [], True

    def local(t):
        return t.to_local() if mesh is not None else t

    for tok, pos in zip(toks, POSITIONS):
        tok = torch.from_numpy(np.array(tok))
        if mesh is not None:
            _, _, tok = registry.shard_decode_inputs(cfg, mesh, token=tok)
        before = [local(c).clone() for c in caches]
        lg, out = step(model, tok, state, pos)
        same &= out is state
        changed.append([not torch.equal(b, local(c))
                        for b, c in zip(before, caches)])
        logits.append(to_replicated(lg))
    return logits, state, changed, same


def long_rank(rank: int, npz_path: str, cases: tuple) -> dict:
    """Per case, on (data 2, model 2): each step's logits (gathered; their
    placements once), the state's leaves gathered, their local block
    shapes and placements, whether every leaf is a DTensor, this rank's
    [start, stop) of the caches' sequence (zamba2), per step whether its
    blocks of the caches changed, whether the step returned the state it
    was given; the unpartitioned port's logits.  Under ``repeat_kv``:
    ``_repeat_kv``'s records."""
    from torch.distributed.tensor import DTensor
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.sharding import local_range
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')
    out = {'repeat_kv': _repeat_kv(mesh)}
    for case in cases:
        arch, over = CASES[case]
        cfg = get_config(arch).reduced(**over)
        p0 = tensors(arrays, f'{case}/p0', np.asarray)
        toks = arrays[f'{case}/tokens']
        logits, state, changed, same = _steps(
            cfg, mesh, interop.lm_params_on_mesh(p0, cfg, mesh,
                                                 device='cpu'), toks)
        plain = interop.lm_params_from_numpy(p0, cfg, device='cpu')
        leaves = flat(state)
        out[case] = {
            'decode_logits': torch.stack([lg.to_local() for lg in logits]),
            'decode_placements': [str(p) for p in logits[0].placements],
            'plain_logits': torch.stack(_steps(cfg, None, plain, toks)[0]),
            'state': {k: v.full_tensor() for k, v in leaves.items()},
            'state_local': {k: tuple(v.to_local().shape)
                            for k, v in leaves.items()},
            'state_placements': {k: [str(p) for p in v.placements]
                                 for k, v in leaves.items()},
            'state_dtensor': all(isinstance(v, DTensor)
                                 for v in leaves.values()),
            'seq_range': (local_range(leaves['kv_k'], 2)
                          if 'kv_k' in leaves else None),
            'changed': changed, 'same_state': same}
    return out
