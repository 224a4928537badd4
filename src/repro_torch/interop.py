"""Carry the JAX package's state across to the port.

The functions take the JAX package's values as numpy arrays (``np.asarray``
of each field) and return the port's objects on the device the caller names
(``device`` is a required keyword: there is no default, so nothing lands on
the CPU unless asked for), so a test can run the JAX function and its port
on the same inputs.  This module imports numpy, not JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.camera import TENSOR_FIELDS, Camera
from .core.gaussians import GaussianScene
from .core.projection import Projected
from .core.radiance_cache import CacheState
from .data.scenes import ChunkedScene, SceneArrays
from .models import moe, registry, whisper, xlstm, zamba2
from .models.transformer import Transformer
from .optim.adam import AdamState


def tensor(x, *, device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor with the same dtype.

    numpy has no bfloat16 of its own: the JAX package's bfloat16 arrays
    carry ``ml_dtypes``' dtype, which ``torch.from_numpy`` refuses.  Their
    bits are carried over as uint16 and viewed as ``torch.bfloat16``."""
    x = np.array(x, copy=True)
    if x.dtype.name == 'bfloat16':
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


def scene_from_numpy(means, log_scales, quats, opacity_logit, sh_dc, sh_rest,
                     *, device) -> GaussianScene:
    return GaussianScene(*(tensor(np.asarray(x, np.float32), device=device)
                           for x in (means, log_scales, quats, opacity_logit,
                                     sh_dc, sh_rest)))


def adam_state_from_numpy(step, mu, nu, *, device) -> AdamState:
    """A JAX ``AdamState`` as the port's: ``step`` its count, ``mu`` and
    ``nu`` its moments as sequences of arrays in the parameters' order
    (``FIELDS`` for a scene).  bfloat16 moments stay bfloat16."""
    def moment(x):
        x = np.asarray(x)
        if x.dtype.name == 'bfloat16':   # numpy has no bfloat16 of its own
            return tensor(x.astype(np.float32), device=device).to(torch.bfloat16)
        return tensor(x, device=device)

    return AdamState(step=tensor(np.asarray(step, np.int32), device=device),
                     mu=tuple(moment(x) for x in mu),
                     nu=tuple(moment(x) for x in nu))


def camera_from_numpy(position, quat, fx, fy, cx, cy, width: int, height: int,
                      near: float = 0.05, far: float = 100.0, *,
                      device) -> Camera:
    f32 = lambda x: tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    host = (np.array(position, np.float32), np.array(quat, np.float32))
    return Camera(position=f32(position), quat=f32(quat), fx=f32(fx),
                  fy=f32(fy), cx=f32(cx), cy=f32(cy), width=int(width),
                  height=int(height), near=float(near), far=float(far),
                  host_pose=host)


def chunked_scene_from_numpy(packed, cells, fill, cell_size: float,
                             chunk_cap: int, source_count: int) -> ChunkedScene:
    """A JAX ``ChunkedScene`` (``packed``: its six packed fields in scene
    order) as the port's.  The partition is host-side: numpy, no device."""
    return ChunkedScene(
        packed=SceneArrays(*(np.array(x, np.float32, copy=True)
                             for x in packed)),
        cells=np.array(cells, np.int64, copy=True),
        fill=np.array(fill, np.int64, copy=True),
        cell_size=float(cell_size), chunk_cap=int(chunk_cap),
        source_count=int(source_count))


def cache_from_numpy(tags, values, age, clock, *, device) -> CacheState:
    return CacheState(tags=tensor(np.asarray(tags, np.int32), device=device),
                      values=tensor(np.asarray(values, np.float32), device=device),
                      age=tensor(np.asarray(age, np.int32), device=device),
                      clock=tensor(np.asarray(clock, np.int32), device=device))



def _camera_arrays(cam, *, lane: bool, device) -> dict:
    """A JAX camera's (or stacked cameras') pose tensors by name; ``lane``
    gives a single camera the leading [1] axis of a one-slot stack."""
    return {f: tensor(np.asarray(getattr(cam, f))[None] if lane
                      else getattr(cam, f), device=device)
            for f in TENSOR_FIELDS}


def _private_arrays(priv, *, lane: bool, device) -> dict:
    def ints(x):
        x = np.asarray(x, np.int64)
        return x[None] if lane else x.copy()
    return {'prev_cam': _camera_arrays(priv.prev_cam, lane=lane,
                                       device=device),
            'frame_idx': ints(priv.frame_idx),
            'cell_id': ints(priv.cell_id)}


def serving_state_from_numpy(arrays, meta: dict, *, device) -> tuple:
    """A JAX ``BatchedStepper.state_dict()`` as what the port's
    ``BatchedStepper.load_state`` takes.

    ``arrays`` is the JAX snapshot's arrays tree with numpy leaves (its
    ``SceneShared`` with a [C, P] pool, ``ViewerPrivate`` and cameras,
    read by attribute) and ``meta`` its JSON meta, whose keys the port's
    meta shares.  The pool's stacked entries are split per (scene, entry),
    each private lane loses its pool index (``meta['slot_pool']`` carries
    it), the counters become int64 host arrays and a stashed lane becomes a
    one-slot stack.  A streamed snapshot's arena (``arrays['stream']``, a
    scene of numpy fields) becomes the port's ``SceneArrays`` of tensors,
    and its residency mirrors (``meta['stream']``) carry over as they are.
    Returns ``(arrays, meta)``."""
    sh = arrays['shared']
    pool = sh.pool
    c, p = np.asarray(sh.pool_cell).shape

    def entry(ci, pi):
        return {'proj': {f.name: tensor(np.asarray(
                    getattr(pool.proj, f.name))[ci, pi], device=device)
                    for f in dataclasses.fields(Projected)},
                'indices': tensor(np.asarray(pool.lists.indices)[ci, pi],
                                  device=device),
                'count': tensor(np.asarray(pool.lists.count)[ci, pi],
                                device=device)}

    out = {
        'cache': {f: tensor(getattr(sh.cache, f), device=device)
                  for f in ('tags', 'values', 'age', 'clock')},
        'pool': tuple(tuple(entry(ci, pi) for pi in range(p))
                      for ci in range(c)),
        'priv': _private_arrays(arrays['priv'], lane=False, device=device),
        'slot_cams': _camera_arrays(arrays['slot_cams'], lane=False,
                                    device=device),
    }
    if arrays.get('stash'):
        out['stash'] = {
            k: {'priv': _private_arrays(v['priv'], lane=True, device=device),
                'cam': _camera_arrays(v['cam'], lane=True, device=device)}
            for k, v in arrays['stash'].items()}
    if 'stream' in meta:
        arena = arrays['stream']['arena']
        out['stream'] = {'arena': SceneArrays(*(
            tensor(getattr(arena, f), device=device)
            for f in SceneArrays._fields))}
    return out, dict(meta)


def _unstack(tree, n: int) -> list:
    """A tree whose leaves are stacked on a leading [n] axis as n trees."""
    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return np.asarray(t)[i]
    return [layer(tree, i) for i in range(n)]


def _lm_tree(params, cfg) -> dict:
    """A JAX family's parameter tree with its stacked axes unstacked into
    lists, as the port's model takes it (numpy leaves)."""
    p = dict(params)
    if cfg.family == 'encdec':
        p['enc'] = _unstack(p['enc'], cfg.enc_layers or cfg.n_layers)
        p['dec'] = _unstack(p['dec'], cfg.n_layers)
    elif cfg.family == 'hybrid':
        p['mamba'] = _unstack(p['mamba'], cfg.n_layers)
    elif cfg.family == 'ssm':
        n_super, se = xlstm._super(cfg)
        p['blocks'] = _unstack(p['blocks'], n_super if se else cfg.n_layers)
        if se:
            for blk in p['blocks']:
                blk['mlstm'] = _unstack(blk['mlstm'], se - 1)
    else:
        p['blocks'] = _unstack(p['blocks'],
                               cfg.n_layers // max(cfg.moe_every, 1))
    return p


def _to_tensors(tree, *, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v, device=device) for v in tree)
    return tensor(tree, device=device)


_LM = {'dense': Transformer, 'vlm': Transformer, 'moe': moe.MoE,
       'encdec': whisper.Whisper, 'ssm': xlstm.XLSTM, 'hybrid': zamba2.Zamba2}


def lm_params_from_numpy(params, cfg, *, device):
    """A JAX LM parameter tree of any family (nested dicts of numpy arrays,
    each run of layers stacked on a leading axis) as the port's model with
    the same values and dtypes, each leaf's own (float32 leaves of a
    bfloat16 config stay float32): the stacked axes are unstacked into one
    entry a layer (moe ``blocks``; xlstm ``blocks`` and each one's
    ``mlstm``; zamba2 ``mamba``; whisper ``enc`` and ``dec``)."""
    return _LM[cfg.family](cfg, _to_tensors(_lm_tree(params, cfg),
                                            device=device))


def lm_params_on_mesh(params, cfg, mesh, *, device):
    """``lm_params_from_numpy`` laid out on ``mesh`` by the config's
    recipe (``registry.shard_step_inputs``): the JAX package's weights as
    DTensors, each rank keeping its own block, so both packages start a
    partitioned run from the same values."""
    model = lm_params_from_numpy(params, cfg, device=device)
    return registry.shard_step_inputs(cfg, mesh, model)[0]


def decode_state_from_numpy(state, cfg, *, device):
    """A JAX decode state of ``cfg``'s family (``registry.
    init_decode_state``'s tree, numpy leaves) as the port's: the same tree
    of tensors.  A K/V pair for dense, vlm and moe; ``{'self', 'cross'}``
    pairs for encdec; ``{'mlstm', 'slstm_h', 'slstm_c'}`` for ssm;
    ``{'ssm': {'ssm', 'conv'}, 'kv_k', 'kv_v'}`` for hybrid."""
    keyed = cfg.family in ('encdec', 'ssm', 'hybrid')
    if isinstance(state, dict) != keyed:
        raise ValueError(f'{cfg.name}: a {cfg.family} decode state is '
                         f'{"a dict" if keyed else "a K/V pair"}, got '
                         f'{type(state).__name__}')
    return _to_tensors(state, device=device)


def kv_cache_from_numpy(caches, *, device) -> tuple:
    """A JAX dense-family decode state (the K and V caches, [L, B, T, Hkv,
    hd] each) as the port's."""
    return tuple(tensor(c, device=device) for c in caches)
