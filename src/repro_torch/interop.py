"""Carry the JAX package's state across to the port.

The functions take the JAX package's values as numpy arrays (``np.asarray``
of each field) and return the port's objects on the device the caller names
(``device`` is a required keyword: there is no default, so nothing lands on
the CPU unless asked for), so a test can run the JAX function and its port
on the same inputs.  This module imports numpy, not JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.gaussians import GaussianScene
from .core.radiance_cache import CacheState


def tensor(x, *, device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor with the same dtype."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def scene_from_numpy(means, log_scales, quats, opacity_logit, sh_dc, sh_rest,
                     *, device) -> GaussianScene:
    return GaussianScene(*(tensor(np.asarray(x, np.float32), device=device)
                           for x in (means, log_scales, quats, opacity_logit,
                                     sh_dc, sh_rest)))


def camera_from_numpy(position, quat, fx, fy, cx, cy, width: int, height: int,
                      near: float = 0.05, far: float = 100.0, *,
                      device) -> Camera:
    f32 = lambda x: tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    host = (np.array(position, np.float32), np.array(quat, np.float32))
    return Camera(position=f32(position), quat=f32(quat), fx=f32(fx),
                  fy=f32(fy), cx=f32(cx), cy=f32(cy), width=int(width),
                  height=int(height), near=float(near), far=float(far),
                  host_pose=host)


def cache_from_numpy(tags, values, age, clock, *, device) -> CacheState:
    return CacheState(tags=tensor(np.asarray(tags, np.int32), device=device),
                      values=tensor(np.asarray(values, np.float32), device=device),
                      age=tensor(np.asarray(age, np.int32), device=device),
                      clock=tensor(np.asarray(clock, np.int32), device=device))
