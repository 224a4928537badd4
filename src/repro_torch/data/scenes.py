"""Procedural Gaussian scenes.

``structured_scene`` builds a spatially coherent scene — Gaussians laid on
parametric surfaces (sphere / plane / torus) with smooth color fields — so
the temporal and ray-coherence properties Lumina exploits hold, as they do
for trained scenes.  Random numbers come from an explicit
``torch.Generator``; the streams differ from the JAX package's, so the two
packages give different scenes for one seed (tests hand the JAX scene over
through ``repro_torch.interop``).
"""
from __future__ import annotations

import math

import torch

from ..core.gaussians import SH_C0, GaussianScene
from ..device import resolve_device


def _normal(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev)


def _uniform(gen, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def _sphere(gen, n, center, radius, base_color, dev):
    d = _normal(gen, (n, 3), dev)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9)
    means = torch.tensor(center, device=dev) + radius * d
    return means, torch.tensor(base_color, device=dev) + 0.35 * d


def _plane(gen, n, origin, u, v, base_color, dev):
    ab = _uniform(gen, (n, 2), -1.0, 1.0, dev)
    means = (torch.tensor(origin, device=dev) + ab[:, :1] * torch.tensor(u, device=dev)
             + ab[:, 1:2] * torch.tensor(v, device=dev))
    col = torch.tensor(base_color, device=dev) + 0.25 * torch.cat(
        [torch.sin(3 * ab), torch.cos(2 * ab[:, :1] + ab[:, 1:2])], dim=-1)
    return means, col


def _torus(gen, n, center, r_major, r_minor, base_color, dev):
    th = _uniform(gen, (n,), 0.0, 2 * math.pi, dev)
    ph = _uniform(gen, (n,), 0.0, 2 * math.pi, dev)
    x = (r_major + r_minor * torch.cos(ph)) * torch.cos(th)
    y = r_minor * torch.sin(ph)
    z = (r_major + r_minor * torch.cos(ph)) * torch.sin(th)
    means = torch.tensor(center, device=dev) + torch.stack([x, y, z], dim=-1)
    col = torch.tensor(base_color, device=dev) + 0.3 * torch.stack(
        [torch.cos(th), torch.sin(2 * ph), torch.sin(th + ph)], dim=-1)
    return means, col


def structured_scene(generator: torch.Generator | int, num_gaussians: int,
                     scale_range=(0.015, 0.06), *, device=None) -> GaussianScene:
    """A coherent multi-surface scene in the unit-ish cube around the origin.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one.  ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    n1 = num_gaussians // 3
    n2 = num_gaussians // 3
    n3 = num_gaussians - n1 - n2
    m1, c1 = _sphere(generator, n1, (0.0, 0.1, 0.0), 0.45, (0.7, 0.3, 0.25), dev)
    m2, c2 = _plane(generator, n2, (0.0, -0.5, 0.0), (1.2, 0.0, 0.0),
                    (0.0, 0.0, 1.2), (0.25, 0.55, 0.3), dev)
    m3, c3 = _torus(generator, n3, (0.0, 0.35, 0.0), 0.7, 0.12,
                    (0.3, 0.35, 0.75), dev)
    means = torch.cat([m1, m2, m3])
    colors = torch.clamp(torch.cat([c1, c2, c3]), 0.02, 0.98)

    n = num_gaussians
    log_scales = torch.log(_uniform(generator, (n, 3), scale_range[0],
                                    scale_range[1], dev))
    quats = _normal(generator, (n, 4), dev)
    quats[:, 0] += 3.0
    opacity_logit = _uniform(generator, (n,), 0.5, 3.0, dev)
    # invert the SH DC activation: c = SH_C0 * dc + 0.5  =>  dc = (c - 0.5)/SH_C0
    sh_dc = (colors - 0.5) / SH_C0
    sh_rest = 0.08 * _normal(generator, (n, 3, 3), dev)
    return GaussianScene(means, log_scales, quats, opacity_logit, sh_dc, sh_rest)
