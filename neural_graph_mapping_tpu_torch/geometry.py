"""Batched geometric predicates (port of neural_graph_mapping_tpu.geometry)."""

from __future__ import annotations

import torch


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
    radii = torch.as_tensor(radii, dtype=dist_sq.dtype, device=dist_sq.device)
    radii = torch.broadcast_to(radii, c_lead).reshape(c_lead + (1,) * len(s_lead))
    return dist_sq <= radii**2
