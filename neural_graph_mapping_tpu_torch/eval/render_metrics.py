"""Render-quality metrics: PSNR, SSIM and depth-L1 (port of
neural_graph_mapping_tpu.eval.render_metrics).

Images are (H, W, C) tensors, RGB in [0, 1] and depth in meters. PSNR and
SSIM clamp both images to [0, 1]; all three take the optional crop of N
pixels per border. LPIPS is not ported: it needs pretrained weights, and
none are shipped.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _crop(img: torch.Tensor, crop: Optional[int]) -> torch.Tensor:
    if crop:
        return img[crop:-crop, crop:-crop]
    return img


def psnr(rendered: torch.Tensor, target: torch.Tensor, crop: Optional[int] = None) -> float:
    """Peak signal-to-noise ratio, data range 1."""
    a = torch.clamp(_crop(rendered, crop), 0.0, 1.0)
    b = torch.clamp(_crop(target, crop), 0.0, 1.0)
    mse = torch.mean((a - b) ** 2)
    return float(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_separable(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable 2D filtering of (H, W, C)."""
    size = k.shape[0]
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    x = F.conv2d(x, k.reshape(1, 1, size, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, size))
    return x[:, 0].permute(1, 2, 0)


def ssim(
    rendered: torch.Tensor,
    target: torch.Tensor,
    crop: Optional[int] = None,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Structural similarity with a Gaussian window, data range 1."""
    a = torch.clamp(_crop(rendered, crop), 0.0, 1.0)
    b = torch.clamp(_crop(target, crop), 0.0, 1.0)
    k = _gaussian_kernel(kernel_size, sigma, a.device)
    c1 = k1**2
    c2 = k2**2
    mu_a = _filter2d_separable(a, k)
    mu_b = _filter2d_separable(b, k)
    mu_aa = _filter2d_separable(a * a, k)
    mu_bb = _filter2d_separable(b * b, k)
    mu_ab = _filter2d_separable(a * b, k)
    var_a = mu_aa - mu_a**2
    var_b = mu_bb - mu_b**2
    cov = mu_ab - mu_a * mu_b
    score = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(torch.mean(score))


def depthl1(rendered: torch.Tensor, target: torch.Tensor, crop: Optional[int] = None) -> float:
    """Mean absolute depth error over pixels whose target depth is not 0;
    predictions are not clamped. The eval protocol calls it with ``crop``
    None even where PSNR and SSIM crop: the reference's depth-L1 accepts a
    crop and never applies it."""
    a = _crop(rendered, crop)
    b = _crop(target, crop)
    mask = b != 0.0
    denom = torch.clamp(torch.sum(mask), min=1)
    return float(torch.sum(torch.abs(a - b) * mask) / denom)
