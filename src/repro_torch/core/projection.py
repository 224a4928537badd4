"""Projection stage of the 3DGS pipeline (EWA splatting).

Given a camera and a scene, produce per-Gaussian screen-space quantities:
2D means, conics (inverse 2D covariances), projected radii, depths, colors,
opacities and an in-frustum validity mask.  All fixed shape [N, ...].
"""
from __future__ import annotations

import dataclasses

import torch

from . import gaussians as G
from .camera import Camera
from .gaussians import GaussianScene

# Low-pass filter added to 2D covariance (anti-aliasing), as in 3DGS.
COV2D_BLUR = 0.3
# Cutoff: a Gaussian's footprint is bounded by 3 sigma.
CUTOFF_SIGMA = 3.0


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space Gaussians (all [N, ...])."""

    mean2d: torch.Tensor    # [N, 2] pixel coordinates
    conic: torch.Tensor     # [N, 3] (a, b, c): inverse covariance [[a,b],[b,c]]
    radius: torch.Tensor    # [N] bounding radius in pixels
    depth: torch.Tensor     # [N] camera-space z
    color: torch.Tensor     # [N, 3] view-dependent RGB (SH-evaluated)
    opacity: torch.Tensor   # [N]
    valid: torch.Tensor     # [N] bool — inside frustum and non-degenerate

    def replace(self, **kw) -> 'Projected':
        return dataclasses.replace(self, **kw)


def project(scene: GaussianScene, cam: Camera) -> Projected:
    """Project all Gaussians onto the screen of ``cam`` (vectorized EWA)."""
    r_cw = G.quat_to_rotmat(cam.quat).T                  # camera-from-world
    t = (scene.means - cam.position[None, :]) @ r_cw.T   # [N,3] camera frame
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]

    in_depth = (tz > cam.near) & (tz < cam.far)
    tz_safe = torch.where(tz > cam.near, tz, torch.full_like(tz, cam.near))

    # Frustum test with 30% guard band (as in the 3DGS reference).
    lim_x = 1.3 * ((cam.width / 2.0) / cam.fx)
    lim_y = 1.3 * ((cam.height / 2.0) / cam.fy)
    in_fov = (torch.abs(tx / tz_safe) < lim_x) & (torch.abs(ty / tz_safe) < lim_y)

    # Clamped camera coords for the Jacobian (avoids blow-up at frustum edge).
    txc = torch.clamp(tx / tz_safe, -lim_x, lim_x) * tz_safe
    tyc = torch.clamp(ty / tz_safe, -lim_y, lim_y) * tz_safe

    mean2d = torch.stack([cam.fx * tx / tz_safe + cam.cx,
                          cam.fy * ty / tz_safe + cam.cy], dim=-1)

    # Jacobian of perspective projection, [N,2,3].
    zero = torch.zeros_like(tz_safe)
    j = torch.stack([
        torch.stack([cam.fx / tz_safe, zero, -cam.fx * txc / (tz_safe ** 2)],
                    dim=-1),
        torch.stack([zero, cam.fy / tz_safe, -cam.fy * tyc / (tz_safe ** 2)],
                    dim=-1),
    ], dim=-2)

    cov3d = G.covariances_3d(scene)                       # [N,3,3] world
    cov_cam = r_cw @ cov3d @ r_cw.T                       # R_cw Sigma R_cw^T
    cov2d = j @ cov_cam @ j.transpose(-1, -2)             # [N,2,2]
    a = cov2d[:, 0, 0] + COV2D_BLUR
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + COV2D_BLUR

    det = a * c - b * b
    det_ok = det > 1e-12
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # Bounding radius: 3 sigma of the major axis.
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))
    radius = torch.ceil(CUTOFF_SIGMA * torch.sqrt(lam))

    color = G.eval_sh(scene, scene.means - cam.position[None, :])
    valid = in_depth & in_fov & det_ok
    return Projected(
        mean2d=mean2d,
        conic=conic,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        depth=torch.where(valid, tz, torch.full_like(tz, float('inf'))),
        color=color,
        opacity=torch.where(valid, G.opacities(scene),
                            torch.zeros_like(tz)),
        valid=valid,
    )


def recolor(scene: GaussianScene, cam: Camera, proj: Projected) -> Projected:
    """Recompute only the view-dependent colors at a (new) camera pose.

    The S^2 sorting-shared path re-evaluates colors from SH at every
    rendered pose even when sorting is reused."""
    return proj.replace(color=G.eval_sh(scene, scene.means - cam.position[None, :]))


def reproject_geometry(scene: GaussianScene, cam: Camera,
                       proj: Projected) -> Projected:
    """Recompute screen-space geometry + color at pose ``cam``, but KEEP the
    validity/culling decisions of ``proj`` (made at the speculative pose):
    the sorting-shared render path — no culling, no tile rebuild, no sort."""
    fresh = project(scene, cam)
    valid = proj.valid & fresh.valid
    return fresh.replace(
        valid=valid,
        opacity=torch.where(valid, fresh.opacity,
                            torch.zeros_like(fresh.opacity)),
        radius=torch.where(valid, fresh.radius,
                           torch.zeros_like(fresh.radius)),
        depth=torch.where(valid, fresh.depth,
                          torch.full_like(fresh.depth, float('inf'))),
    )
