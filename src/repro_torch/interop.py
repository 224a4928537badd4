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


def lm_params_from_numpy(params, cfg, *, device) -> Transformer:
    """A JAX dense-family parameter tree (nested dicts of numpy arrays,
    the blocks stacked on a leading [L] axis) as the port's model with the
    same values and dtypes: the [L] axis is unstacked into one block a
    layer."""
    blocks = params['blocks']

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tensor(np.asarray(tree)[i], device=device)

    return Transformer(cfg, {
        'tok': {k: tensor(v, device=device)
                for k, v in params['tok'].items()},
        'blocks': [layer(blocks, i) for i in range(cfg.n_layers)]})


def kv_cache_from_numpy(caches, *, device) -> tuple:
    """A JAX dense-family decode state (the K and V caches, [L, B, T, Hkv,
    hd] each) as the port's."""
    return tuple(tensor(c, device=device) for c in caches)
