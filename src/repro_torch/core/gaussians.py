"""Gaussian scene representation for 3DGS.

``GaussianScene`` is an ``nn.Module`` whose six raw (pre-activation) fields
are ``nn.Parameter``s — the trainable representation of Kerbl et al. 2023:

  means         [N, 3]   world-space centers
  log_scales    [N, 3]   log of per-axis scales (activation: exp)
  quats         [N, 4]   unnormalized rotation quaternions (activation: normalize)
  opacity_logit [N]      (activation: sigmoid)
  sh_dc         [N, 3]   degree-0 spherical-harmonic coefficients
  sh_rest       [N, 3, 3] degree-1 SH coefficients (3 basis fns x RGB)

Serving and the early-exit rasterizer run under ``torch.no_grad()``; the
fine-tuning loss (``core.finetune``) renders through the dense walk
(``render_frame_baseline(..., early_exit=False)``) with autograd on, so
gradients reach these parameters.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199

# Alpha below which a Gaussian is insignificant (paper: 1/255).
ALPHA_SIGNIFICANT = 1.0 / 255.0
# Transmittance termination threshold theta (3DGS reference uses 1e-4).
TRANSMITTANCE_EPS = 1.0e-4
ALPHA_MAX = 0.99

FIELDS = ('means', 'log_scales', 'quats', 'opacity_logit', 'sh_dc', 'sh_rest')


class GaussianScene(nn.Module):
    """Trainable scene parameters (raw, pre-activation)."""

    def __init__(self, means, log_scales, quats, opacity_logit, sh_dc,
                 sh_rest):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_logit = nn.Parameter(opacity_logit)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion(s) [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def scales(scene: GaussianScene) -> torch.Tensor:
    return torch.exp(scene.log_scales)


def opacities(scene: GaussianScene) -> torch.Tensor:
    return torch.sigmoid(scene.opacity_logit)


def covariances_3d(scene: GaussianScene) -> torch.Tensor:
    """Sigma = R S S^T R^T, [N, 3, 3]."""
    rot = quat_to_rotmat(scene.quats)                    # [N,3,3]
    m = rot * scales(scene)[:, None, :]                  # R @ diag(s)
    return m @ m.transpose(-1, -2)


def eval_sh(scene: GaussianScene, view_dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate degree-1 SH color for each Gaussian given view dirs [N,3].

    Returns RGB in [0, inf) (clamped at 0 after the +0.5 shift, as in 3DGS).
    """
    d = view_dirs / (torch.linalg.vector_norm(view_dirs, dim=-1, keepdim=True)
                     + 1e-12)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    c = SH_C0 * scene.sh_dc
    c = c - SH_C1 * y * scene.sh_rest[..., 0, :]
    c = c + SH_C1 * z * scene.sh_rest[..., 1, :]
    c = c - SH_C1 * x * scene.sh_rest[..., 2, :]
    return torch.clamp(c + 0.5, min=0.0)


def geometric_mean_scale(scene: GaussianScene) -> torch.Tensor:
    """Geometric mean of the three scale parameters, [N].

    This is the `S` in the paper's scale-constrained loss (Eqn. 4).
    """
    return torch.exp(torch.mean(scene.log_scales, dim=-1))


def init_scene(generator: torch.Generator, num_gaussians: int,
               extent: float = 1.0, *, device=None) -> GaussianScene:
    """Random scene initialization (centers uniform in a cube of half-side
    ``extent``).  ``generator`` is a ``torch.Generator`` on ``device`` (the
    card by default); its stream is not ``jax.random``'s, so one seed gives
    another scene than the JAX package's."""
    dev = resolve_device(device)
    n = num_gaussians

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    means = uniform((n, 3), -extent, extent)
    log_scales = torch.log(uniform((n, 3), 0.02, 0.08) * extent)
    quats = normal((n, 4))
    quats[:, 0] += 2.0  # bias toward identity
    opacity_logit = uniform((n,), -1.0, 2.0)
    sh_dc = uniform((n, 3), -1.0, 1.0)
    sh_rest = 0.1 * normal((n, 3, 3))
    return GaussianScene(means, log_scales, quats, opacity_logit, sh_dc,
                         sh_rest)


def scene_num_params(scene: GaussianScene) -> int:
    return sum(math.prod(getattr(scene, f).shape) for f in FIELDS)
