"""Batched geometric predicates (port of neural_graph_mapping_tpu.geometry)."""

from __future__ import annotations

from typing import Tuple

import torch


def spheres_to_aabbs(centers: torch.Tensor, radii) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB of each sphere: centers (..., 3), radii scalar or (...)
    -> (minima, maxima), each (..., 3)."""
    radii = torch.as_tensor(radii, dtype=centers.dtype, device=centers.device)
    radii = torch.broadcast_to(radii, centers.shape[:-1])[..., None]
    return centers - radii, centers + radii


def aabbs_intersect(
    min_a: torch.Tensor, max_a: torch.Tensor, min_b: torch.Tensor, max_b: torch.Tensor
) -> torch.Tensor:
    """Which AABBs of set B (...b, 3) intersect which of set A (...a, 3)
    -> bool (...b, ...a)."""
    a_lead = min_a.shape[:-1]
    b_lead = min_b.shape[:-1]
    min_b = min_b.reshape(b_lead + (1,) * len(a_lead) + (3,))
    max_b = max_b.reshape(b_lead + (1,) * len(a_lead) + (3,))
    return torch.all(min_b <= max_a, dim=-1) & torch.all(max_b >= min_a, dim=-1)


def closest_points_on_segments(
    p1s: torch.Tensor, p2s: torch.Tensor, points: torch.Tensor
) -> torch.Tensor:
    """Closest point on each segment (...s, 3) for each query (...p, 3)
    -> (...p, ...s, 3)."""
    p1s, p2s = torch.broadcast_tensors(p1s, p2s)
    s_lead = p1s.shape[:-1]
    p_lead = points.shape[:-1]
    dirs = p2s - p1s
    sq = torch.sum(dirs * dirs, dim=-1, keepdim=True)
    sq = torch.where(sq == 0.0, torch.ones_like(sq), sq)  # zero length -> p1
    pts = points.reshape(p_lead + (1,) * len(s_lead) + (3,))
    t = torch.sum((pts - p1s) * dirs, dim=-1, keepdim=True) / sq
    return p1s + dirs * torch.clamp(t, 0.0, 1.0)


def segments_intersect_spheres(
    p1s: torch.Tensor, p2s: torch.Tensor, centers: torch.Tensor, radii
) -> torch.Tensor:
    """Which sphere (...c) intersects which segment (...s) -> bool (...c, ...s)."""
    p1s, p2s = torch.broadcast_tensors(p1s, p2s)
    s_lead = p1s.shape[:-1]
    c_lead = centers.shape[:-1]
    closest = closest_points_on_segments(p1s, p2s, centers)
    ctr = centers.reshape(c_lead + (1,) * len(s_lead) + (3,))
    dist_sq = torch.sum((ctr - closest) ** 2, dim=-1)
    radii = torch.as_tensor(radii, dtype=dist_sq.dtype)
    if radii.dim() == 0 and radii.device.type == "cpu":
        # one radius, squared on the host: its upload would wait for the device
        return dist_sq <= (radii * radii).item()
    radii = torch.broadcast_to(radii.to(dist_sq.device), c_lead).reshape(c_lead + (1,) * len(s_lead))
    return dist_sq <= radii**2


def rays_intersect_spheres(
    origins: torch.Tensor, endpoints: torch.Tensor, centers: torch.Tensor, radii
) -> torch.Tensor:
    """The segment-vs-sphere test at the single-view sampler's shapes: one
    shared origin, P endpoints, F spheres -> bool (F, P)."""
    return segments_intersect_spheres(origins, endpoints, centers, radii)
