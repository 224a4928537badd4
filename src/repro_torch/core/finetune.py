"""Cache-aware end-to-end fine-tuning (paper Sec. 3.3, Eqn. 4).

    L_total = L_orig + alpha * L_scale(S, theta)

where L_orig is the original 3DGS loss ((1-lam)*L1 + lam*(1-SSIM), lam=0.2)
and L_scale penalizes the geometric mean S of each Gaussian's three scales
above a threshold theta — keeping Gaussians small so the RC assumption
("rays sharing the first k significant Gaussians have the same color") holds.

Sorting and cache lookup stay outside the gradient path: tile lists are
integer indices, and training renders through the full integration (the
dense walk of ``render_frame_baseline(..., early_exit=False)``; the cache
only affects inference), so the pipeline is end-to-end differentiable as
the paper describes (Fig. 14).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import metrics
from .camera import Camera
from .gaussians import FIELDS, GaussianScene, geometric_mean_scale
from .pipeline import LuminaConfig, render_frame_baseline
from ..optim import adam


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    lam_dssim: float = 0.2       # 3DGS loss mixing weight
    scale_alpha: float = 0.0     # alpha in Eqn. 4 (0 = plain 3DGS loss)
    scale_theta: float = 0.03    # theta: allowed geometric-mean scale
    adam: adam.AdamConfig = adam.AdamConfig(lr=5e-3, clip_norm=None,
                                            weight_decay=0.0)


class FinetuneMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    dssim: torch.Tensor
    l_scale: torch.Tensor
    psnr: torch.Tensor


def params_of(scene: GaussianScene) -> list:
    """The scene's parameters in ``FIELDS`` order (the optimizer's order)."""
    return [getattr(scene, f) for f in FIELDS]


def scale_loss(scene: GaussianScene, theta: float) -> torch.Tensor:
    """L_scale: mean penalty on geometric-mean scales exceeding theta."""
    s = geometric_mean_scale(scene)
    return torch.mean(torch.clamp(s - theta, min=0.0))


def total_loss(scene: GaussianScene, cam: Camera, gt: torch.Tensor,
               cfg: FinetuneConfig, render_cfg: LuminaConfig, *, device=None):
    """(loss, FinetuneMetrics); the loss carries the graph back to the
    scene's parameters, the metrics are detached."""
    # early_exit=False: the chunked early-exit walk selects rows on the
    # host and writes them in place, so no gradient passes through it
    image, _, _, _ = render_frame_baseline(scene, cam, render_cfg,
                                           early_exit=False, device=device)
    l1 = torch.mean(torch.abs(image - gt))
    dssim = 1.0 - metrics.ssim(image, gt)
    l_orig = (1 - cfg.lam_dssim) * l1 + cfg.lam_dssim * dssim
    l_sc = scale_loss(scene, cfg.scale_theta)
    loss = l_orig + cfg.scale_alpha * l_sc
    with torch.no_grad():
        aux = FinetuneMetrics(loss=loss.detach(), l1=l1.detach(),
                              dssim=dssim.detach(), l_scale=l_sc.detach(),
                              psnr=metrics.psnr(image, gt))
    return loss, aux


def make_train_step(cfg: FinetuneConfig, render_cfg: LuminaConfig, *,
                    device=None):
    """Returns (scene, opt_state, cam, gt) -> (scene, opt_state, metrics);
    the step updates the scene's parameters in place."""

    def train_step(scene: GaussianScene, opt_state: adam.AdamState,
                   cam: Camera, gt: torch.Tensor):
        params = params_of(scene)
        loss, aux = total_loss(scene, cam, gt, cfg, render_cfg, device=device)
        grads = torch.autograd.grad(loss, params)
        _, opt_state, _ = adam.step(params, grads, opt_state, cfg.adam)
        return scene, opt_state, aux

    return train_step


def finetune(scene: GaussianScene, cams, gts, cfg: FinetuneConfig,
             render_cfg: LuminaConfig, steps: int, log_every: int = 0, *,
             device=None):
    """Simple fine-tuning loop cycling through (cams, gts) pairs.  Tunes a
    copy of ``scene`` and returns (tuned copy, per-step metrics); the
    caller's scene is left as it was."""
    scene = GaussianScene(*(p.detach().clone() for p in params_of(scene)))
    opt_state = adam.init(params_of(scene), cfg.adam)
    train_step = make_train_step(cfg, render_cfg, device=device)
    history = []
    for i in range(steps):
        j = i % len(cams)
        scene, opt_state, aux = train_step(scene, opt_state, cams[j], gts[j])
        history.append(aux)
        if log_every and i % log_every == 0:
            print(f'  step {i}: loss={float(aux.loss):.4f} psnr={float(aux.psnr):.2f} '
                  f'l_scale={float(aux.l_scale):.5f}')
    return scene, history
