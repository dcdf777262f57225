"""Render-quality metrics: PSNR, SSIM, depth-L1 and LPIPS (port of
neural_graph_mapping_tpu.eval.render_metrics).

Images are (H, W, C) tensors, RGB in [0, 1] and depth in meters. PSNR, SSIM
and LPIPS clamp both images to [0, 1]; all four take the optional crop of N
pixels per border. LPIPS needs pretrained weights, which are not shipped:
they come from the ``.npz`` that ``NGM_LPIPS_WEIGHTS`` names.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# LPIPS (AlexNet backbone, torchmetrics-compatible) with externally supplied
# weights: none can be downloaded.
# ---------------------------------------------------------------------------

_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)
# (stride, padding, max-pool stride after the layer) of torchvision's
# AlexNet features; conv0's padding is 2, not the (11 - 1) // 2 of 'same'
_LPIPS_CONVS = ((4, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1), (1, 1, 1))


@functools.lru_cache(maxsize=1)
def _lpips_weights():
    path = os.environ.get("NGM_LPIPS_WEIGHTS", "")
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(
            "LPIPS weights not available (set NGM_LPIPS_WEIGHTS to an .npz "
            "exported by scripts/export_lpips.py)"
        )
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in data.items()}


def lpips(rendered: torch.Tensor, target: torch.Tensor, crop: Optional[int] = None) -> float:
    """LPIPS perceptual distance, AlexNet variant.

    Images (H, W, 3) in [0, 1], scaled to [-1, 1] and then shifted and
    scaled as torchmetrics does with ``normalize=True``.
    """
    dev = rendered.device
    w = {k: v.to(dev) for k, v in _lpips_weights().items()}
    shift = torch.tensor(_LPIPS_SHIFT, device=dev)
    scale = torch.tensor(_LPIPS_SCALE, device=dev)
    a = torch.clamp(_crop(rendered, crop), 0.0, 1.0)
    b = torch.clamp(_crop(target.to(dev), crop), 0.0, 1.0)

    def net_feats(img):
        x = ((2.0 * img - 1.0 - shift) / scale).permute(2, 0, 1)[None]  # (1, 3, H, W)
        feats = []
        for i, (stride, pad, pool) in enumerate(_LPIPS_CONVS):
            x = torch.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=stride, padding=pad))
            feats.append(x)
            if pool > 1 and i < len(_LPIPS_CONVS) - 1:
                x = F.max_pool2d(x, kernel_size=3, stride=pool)
        return feats

    total = 0.0
    for i, (xa, xb) in enumerate(zip(net_feats(a), net_feats(b))):
        na = xa / (torch.linalg.norm(xa, dim=1, keepdim=True) + 1e-10)
        nb = xb / (torch.linalg.norm(xb, dim=1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * w[f"lin{i}_w"], dim=1))
    return float(total)
