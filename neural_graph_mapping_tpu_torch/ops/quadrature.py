"""Volume-rendering quadrature (port of neural_graph_mapping_tpu.ops.quadrature,
training path)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def occupancy_probs(
    geometry_mode: str,
    sample_geometries: torch.Tensor,
    sample_distances: torch.Tensor,
    geometry_factor: float,
    neus_isds: Optional[torch.Tensor] = None,
):
    """Per-sample occupancy probability + whether the last sample is dropped
    (density / occupancy / neus / nrgbd, as in the JAX package)."""
    if geometry_mode == "density":
        deltas = sample_distances[..., 1:] - sample_distances[..., :-1]
        occ = 1.0 - torch.exp(-deltas * torch.relu(sample_geometries[..., :-1]))
        drops_last = True
    elif geometry_mode == "occupancy":
        occ = 1.0 / (1.0 + torch.exp(-geometry_factor * sample_geometries))
        drops_last = False
    elif geometry_mode == "neus":
        if neus_isds is None:
            raise ValueError("neus mode requires neus_isds")
        tno = 1.0 / (1.0 + torch.exp(-neus_isds * geometry_factor * sample_geometries))
        occ = torch.relu((tno[..., :-1] - tno[..., 1:]) / (tno[..., :-1] + 1e-5))
        drops_last = True
    elif geometry_mode == "nrgbd":
        # symmetric bell around the surface: 4*s(t)*s(-t) == 4*s(t)*(1-s(t))
        sig = 1.0 / (1.0 + torch.exp(-(geometry_factor * sample_geometries)))
        occ = 4.0 * sig * (1.0 - sig)
        drops_last = False
    else:
        raise ValueError(f"Unknown geometry_mode {geometry_mode!r}")
    return occ, drops_last


class QuadratureResultFM(NamedTuple):
    colors: torch.Tensor  # (F, 3, R) channel-major expected ray colors
    depths: torch.Tensor  # (F, R)
    color_vars: torch.Tensor  # (F, 3, R)
    depth_vars: torch.Tensor  # (F, R)
    term_probs: torch.Tensor  # (F, R)


def quadrature_fm(
    geometry_mode: str,
    sample_colors: torch.Tensor,  # (F, 3, R, S) channel-major
    sample_geometries: torch.Tensor,  # (F, R, S)
    sample_distances: torch.Tensor,  # (F, R, S)
    sample_depths: torch.Tensor,  # (F, R, S)
    geometry_factor: float = 1.0,
    neus_isds: Optional[torch.Tensor] = None,
) -> QuadratureResultFM:
    """Alpha-composite samples along rays, colors channel-major."""
    occ, drops_last = occupancy_probs(
        geometry_mode, sample_geometries, sample_distances, geometry_factor, neus_isds
    )
    non_term = torch.cat(
        [torch.ones_like(occ[..., :1]), torch.cumprod(1.0 - occ[..., :-1], dim=-1)], dim=-1
    )
    weights = occ * non_term
    bg_weight = 1.0 - torch.sum(weights, dim=-1)

    last = -1 if drops_last else None
    colors_s = sample_colors[..., :last]
    depths_s = sample_depths[..., :last]
    colors = torch.einsum("fcrs,frs->fcr", colors_s, weights)
    depths = torch.sum(depths_s * weights, dim=-1)
    color_vars = torch.einsum("fcrs,frs->fcr", (colors[..., None] - colors_s) ** 2, weights)
    depth_vars = torch.sum(weights * (depths[..., None] - depths_s) ** 2, dim=-1)
    return QuadratureResultFM(
        colors=colors,
        depths=depths,
        color_vars=color_vars,
        depth_vars=depth_vars,
        term_probs=1.0 - bg_weight,
    )
