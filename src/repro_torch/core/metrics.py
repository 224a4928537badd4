"""Image quality metrics: PSNR and SSIM."""
from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, *,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter, VALID padding. img: [H, W, C].  ``conv2d`` is a
    cross-correlation, as XLA's convolution is; the window is symmetric
    either way."""
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                        # [1,C,H,W]
    k = kern[None, None].expand(c, 1, *kern.shape)         # [C,1,kh,kw]
    y = torch.nn.functional.conv2d(x, k, groups=c)
    return y[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Standard single-scale SSIM with an 11x11 Gaussian window (sigma 1.5)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kern = _gaussian_kernel(device=a.device)
    mu_a = _filter2d(a, kern)
    mu_b = _filter2d(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d(a * a, kern) - mu_aa
    s_bb = _filter2d(b * b, kern) - mu_bb
    s_ab = _filter2d(a * b, kern) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)
