"""Loss functions for the mapping optimizer (port of
neural_graph_mapping_tpu.ops.losses). Every loss takes an explicit boolean
mask and takes a masked mean, as the JAX package does.

The ``*_values`` functions give the elementwise values each loss averages;
with the field axis sharded over ranks (``mapping/engine.py``), each rank
sums its values and mask with :func:`masked_sums` and divides by the global
mask count, so the masked means span every rank's targets."""

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


def masked_sums(values: torch.Tensor, mask: torch.Tensor):
    """(sum of values where mask, mask count): a masked mean's numerator
    and denominator, the mask broadcast to the values' shape."""
    mask = torch.broadcast_to(mask, values.shape).to(values.dtype)
    return torch.sum(values * mask), torch.sum(mask)


def photometric_values(
    mode: str,
    measured_colors: torch.Tensor,
    rendered_colors: torch.Tensor,
    rendered_color_vars: Optional[torch.Tensor] = None,
):
    """The values :func:`photometric_loss` averages: one tensor for l1 and
    l2; for gaussian_nll the NLL and the absolute error, of which the loss
    takes the second's mean where the first's passes 2."""
    diff = rendered_colors - measured_colors
    if mode == "l1":
        return (torch.abs(diff),)
    if mode == "l2":
        return (diff**2,)
    if mode == "gaussian_nll":
        nll = 0.5 * diff**2 / rendered_color_vars + 0.5 * torch.log(rendered_color_vars)
        return nll, torch.abs(diff)
    raise ValueError(f"Unknown photometric loss mode {mode!r}")


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
    values = photometric_values(mode, measured_colors, rendered_colors, rendered_color_vars)
    if mode == "gaussian_nll":
        nll_mean = masked_mean(values[0], mask)
        return torch.where(nll_mean > 2.0, masked_mean(values[1], mask), nll_mean)
    return masked_mean(values[0], mask)


def huber(residuals: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise Huber loss, matching torch.nn.functional.huber_loss."""
    abs_r = torch.abs(residuals)
    return torch.where(abs_r <= delta, 0.5 * residuals**2, delta * (abs_r - 0.5 * delta))


def depth_values(
    mode: str,
    measured_depths: torch.Tensor,
    rendered_depths: torch.Tensor,
    rendered_depth_vars: Optional[torch.Tensor] = None,
    huber_delta: float = 0.05,
) -> torch.Tensor:
    """The values :func:`depth_loss` averages."""
    diff = rendered_depths - measured_depths
    if mode == "huber":
        return huber(diff, huber_delta)
    if mode == "gaussian_nll":
        var = rendered_depth_vars + 1e-15
        return 0.5 * diff**2 / var + 0.5 * torch.log(var)
    if mode == "laplacian_nll":
        return torch.abs(diff) / torch.sqrt(0.5 * rendered_depth_vars + 1e-6) + 0.5 * torch.log(
            2.0 * rendered_depth_vars + 1e-6
        )
    raise ValueError(f"Unknown depth loss mode {mode!r}")


def depth_loss(
    mode: str,
    measured_depths: torch.Tensor,
    rendered_depths: torch.Tensor,
    rendered_depth_vars: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    huber_delta: float = 0.05,
) -> torch.Tensor:
    """Depth error (huber / gaussian_nll / laplacian_nll)."""
    return masked_mean(depth_values(mode, measured_depths, rendered_depths, rendered_depth_vars, huber_delta), mask)


def termination_values(pred_term_probs: torch.Tensor, target_term_probs: torch.Tensor) -> torch.Tensor:
    return (pred_term_probs - target_term_probs) ** 2


def termination_loss(
    pred_term_probs: torch.Tensor, target_term_probs: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """MSE on ray termination probability."""
    return masked_mean(termination_values(pred_term_probs, target_term_probs), mask)


def freespace_values(sample_geometries: torch.Tensor, truncation_distance: float) -> torch.Tensor:
    residual = sample_geometries * truncation_distance - truncation_distance
    return residual**2


def freespace_loss(
    sample_geometries: torch.Tensor, truncation_distance: float, mask: torch.Tensor
) -> torch.Tensor:
    """Geometry in empty space should predict +truncation."""
    return masked_mean(freespace_values(sample_geometries, truncation_distance), mask)


def tsdf_values(sample_geometries: torch.Tensor, deltas: torch.Tensor, truncation_distance: float) -> torch.Tensor:
    residual = sample_geometries * truncation_distance - deltas
    return residual**2


def tsdf_loss(
    sample_geometries: torch.Tensor,
    deltas: torch.Tensor,
    truncation_distance: float,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Truncated-SDF loss near the surface: g * trunc ~= gt - sample distance."""
    return masked_mean(tsdf_values(sample_geometries, deltas, truncation_distance), mask)


def eikonal_term(gradients: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared deviation of the SDF gradient norm from 1, from precomputed
    spatial gradients (..., d) (``NeuralField.geometry_gradients``)."""
    norms = torch.linalg.norm(gradients, dim=-1)
    return masked_mean((norms - 1.0) ** 2, mask)
