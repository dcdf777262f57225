"""Loss functions for the mapping optimizer (port of
neural_graph_mapping_tpu.ops.losses). Every loss takes an explicit boolean
mask and takes a masked mean, as the JAX package does."""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of values where mask is True; 0 if the mask is empty."""
    if mask is None:
        return torch.mean(values)
    mask = torch.broadcast_to(mask, values.shape).to(values.dtype)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(values * mask) / denom


def photometric_loss(
    mode: str,
    measured_colors: torch.Tensor,
    rendered_colors: torch.Tensor,
    rendered_color_vars: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Photometric error; mask broadcasts over (..., 3)."""
    if mask is not None and mask.ndim == measured_colors.ndim - 1:
        mask = mask[..., None]
    diff = rendered_colors - measured_colors
    if mode == "l1":
        return masked_mean(torch.abs(diff), mask)
    if mode == "l2":
        return masked_mean(diff**2, mask)
    if mode == "gaussian_nll":
        nll = 0.5 * diff**2 / rendered_color_vars + 0.5 * torch.log(rendered_color_vars)
        nll_mean = masked_mean(nll, mask)
        return torch.where(nll_mean > 2.0, masked_mean(torch.abs(diff), mask), nll_mean)
    raise ValueError(f"Unknown photometric loss mode {mode!r}")


def huber(residuals: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise Huber loss, matching torch.nn.functional.huber_loss."""
    abs_r = torch.abs(residuals)
    return torch.where(abs_r <= delta, 0.5 * residuals**2, delta * (abs_r - 0.5 * delta))


def depth_loss(
    mode: str,
    measured_depths: torch.Tensor,
    rendered_depths: torch.Tensor,
    rendered_depth_vars: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    huber_delta: float = 0.05,
) -> torch.Tensor:
    """Depth error (huber / gaussian_nll / laplacian_nll)."""
    diff = rendered_depths - measured_depths
    if mode == "huber":
        return masked_mean(huber(diff, huber_delta), mask)
    if mode == "gaussian_nll":
        var = rendered_depth_vars + 1e-15
        return masked_mean(0.5 * diff**2 / var + 0.5 * torch.log(var), mask)
    if mode == "laplacian_nll":
        nll = torch.abs(diff) / torch.sqrt(0.5 * rendered_depth_vars + 1e-6) + 0.5 * torch.log(
            2.0 * rendered_depth_vars + 1e-6
        )
        return masked_mean(nll, mask)
    raise ValueError(f"Unknown depth loss mode {mode!r}")


def termination_loss(
    pred_term_probs: torch.Tensor, target_term_probs: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """MSE on ray termination probability."""
    return masked_mean((pred_term_probs - target_term_probs) ** 2, mask)


def freespace_loss(
    sample_geometries: torch.Tensor, truncation_distance: float, mask: torch.Tensor
) -> torch.Tensor:
    """Geometry in empty space should predict +truncation."""
    residual = sample_geometries * truncation_distance - truncation_distance
    return masked_mean(residual**2, mask)


def tsdf_loss(
    sample_geometries: torch.Tensor,
    deltas: torch.Tensor,
    truncation_distance: float,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Truncated-SDF loss near the surface: g * trunc ~= gt - sample distance."""
    residual = sample_geometries * truncation_distance - deltas
    return masked_mean(residual**2, mask)


def eikonal_term(gradients: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared deviation of the SDF gradient norm from 1, from precomputed
    spatial gradients (..., d) (``NeuralField.geometry_gradients``)."""
    norms = torch.linalg.norm(gradients, dim=-1)
    return masked_mean((norms - 1.0) ** 2, mask)
