"""Pinhole camera model and pose utilities."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .gaussians import quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class Camera:
    """A camera pose + intrinsics.

    position : [3]   camera center in world coordinates
    quat     : [4]   world-from-camera rotation quaternion (w,x,y,z)
    fx, fy   : focal lengths (pixels), 0-d float32 tensors
    cx, cy   : principal point (pixels), 0-d float32 tensors
    width, height : Python ints (image size in pixels)
    near, far     : clip planes
    host_pose     : (position, quat) as float32 numpy arrays when the pose
                    was made on the host, else None.  The serving scheduler
                    keys pose cells from it without reading the device.

    A stack of S cameras (``stack_cameras``) has the same fields with a
    leading [S] axis on every tensor; ``camera_at`` takes one back out.
    """

    position: torch.Tensor
    quat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    near: float = 0.05
    far: float = 100.0
    host_pose: tuple | None = dataclasses.field(default=None, compare=False,
                                                repr=False)

    def replace(self, **kw) -> 'Camera':
        # a new pose invalidates the host copy of the old one
        if 'position' in kw or 'quat' in kw:
            kw.setdefault('host_pose', None)
        return dataclasses.replace(self, **kw)


TENSOR_FIELDS = ('position', 'quat', 'fx', 'fy', 'cx', 'cy')


def stack_cameras(cams: list) -> Camera:
    """Stack cameras with identical static fields into one batched Camera
    (every tensor gains a leading [S] axis).  The host poses stack too when
    every camera has one."""
    first = cams[0]
    for c in cams[1:]:
        if (c.width, c.height, c.near, c.far) != (first.width, first.height,
                                                  first.near, first.far):
            raise ValueError('stack_cameras requires identical static fields')
    host = None
    if all(c.host_pose is not None for c in cams):
        host = tuple(np.stack([c.host_pose[i] for c in cams]) for i in (0, 1))
    return Camera(**{f: torch.stack([getattr(c, f) for c in cams])
                     for f in TENSOR_FIELDS},
                  width=first.width, height=first.height, near=first.near,
                  far=first.far, host_pose=host)


def camera_at(cams: Camera, i) -> Camera:
    """Camera ``i`` (an int, or an index tensor for a sub-stack) of a
    stacked Camera."""
    host = cams.host_pose
    if host is not None:
        idx = i.cpu().numpy() if isinstance(i, torch.Tensor) else i
        host = (host[0][idx], host[1][idx])
    return dataclasses.replace(
        cams, **{f: getattr(cams, f)[i] for f in TENSOR_FIELDS},
        host_pose=host)


def camera_to(cam: Camera, device) -> Camera:
    """The camera (or stacked cameras) with its tensors on ``device``; the
    host copy of the pose carries over."""
    return dataclasses.replace(
        cam, **{f: getattr(cam, f).to(device) for f in TENSOR_FIELDS})


def camera_arrays(cam: Camera, copy: bool = True) -> dict:
    """The camera's tensors by field name (copies unless ``copy`` is
    False): what a saved serving state holds of a camera."""
    return {f: getattr(cam, f).clone() if copy else getattr(cam, f)
            for f in TENSOR_FIELDS}


def camera_from_arrays(like: Camera, arrays: dict, device) -> Camera:
    """``like``'s static fields with copies of the named tensors (or
    arrays) on ``device``.  The host copy of the pose is read back from
    them, so the scheduler keys pose cells from the pose the device holds."""
    t = {f: torch.as_tensor(arrays[f]).to(device, copy=True)
         for f in TENSOR_FIELDS}
    host = tuple(t[f].cpu().numpy().copy() for f in ('position', 'quat'))
    return dataclasses.replace(like, **t, host_pose=host)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_camera(position, quat, fov_x_deg: float, width: int, height: int,
                near: float = 0.05, far: float = 100.0,
                device=None) -> Camera:
    fov_x = _f32(fov_x_deg) * _f32(math.pi / 180.0)    # deg2rad in float32
    fx = (width / 2.0) / torch.tan(fov_x / 2.0)
    p, q = _f32(position), _f32(quat)
    host = None
    if p.device.type == 'cpu' and q.device.type == 'cpu':
        host = (p.numpy().copy(), q.numpy().copy())
    return Camera(position=p.to(device), quat=q.to(device),
                  fx=fx.to(device), fy=fx.clone().to(device),
                  cx=_f32(width / 2.0, device), cy=_f32(height / 2.0, device),
                  width=width, height=height, near=near, far=far,
                  host_pose=host)


def world_to_camera(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """World points [N,3] -> camera-frame points [N,3] (z = depth)."""
    r_wc = quat_to_rotmat(cam.quat)          # world-from-camera
    r_cw = r_wc.T                            # camera-from-world
    return (points - cam.position[None, :]) @ r_cw.T


def expand_viewport(cam: Camera, margin_px: int) -> Camera:
    """Expanded sorting viewport for S^2 (Sec. 3.1 of the paper): the
    viewport grows by ``margin_px`` pixels on each side and the principal
    point shifts so world geometry stays put."""
    return cam.replace(cx=cam.cx + margin_px, cy=cam.cy + margin_px,
                       width=cam.width + 2 * margin_px,
                       height=cam.height + 2 * margin_px)


def look_at(position, target, up=(0.0, 1.0, 0.0)):
    """Return a (position, quat) pose looking from ``position`` toward
    ``target`` (COLMAP/3DGS convention: +z forward, +x right, +y down)."""
    position = _f32(position)
    target = _f32(target)
    up = _f32(up)
    fwd = target - position
    fwd = fwd / (torch.linalg.vector_norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.vector_norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)
    r = torch.stack([right, down, fwd], dim=1)   # world-from-camera columns
    return position, rotmat_to_quat(r)


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [3,3] -> quaternion (w,x,y,z). Branch-free (Shepperd)."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1 + tr, min=1e-12)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=1e-12)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=1e-12)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=1e-12)) / 2
    cand = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                     (m10 - m01) / (4 * qw)]),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                     (m02 + m20) / (4 * qx)]),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                     (m12 + m21) / (4 * qy)]),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                     (m12 + m21) / (4 * qz), qz]),
    ])
    q = cand[torch.argmax(torch.stack([tr, m00, m11, m22]))]
    return q / (torch.linalg.vector_norm(q) + 1e-12)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: float) -> torch.Tensor:
    """Spherical interpolation/extrapolation of quaternions (t may exceed 1)."""
    q0 = q0 / (torch.linalg.vector_norm(q0) + 1e-12)
    q1 = q1 / (torch.linalg.vector_norm(q1) + 1e-12)
    dot = torch.sum(q0 * q1)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.vector_norm(q) + 1e-12)
