"""Top-2 nearest valid field centres per point: the plain PyTorch version of
the render dispatch's ``topk2_fields`` kernel (counterpart of
``neural_graph_mapping_tpu/ops/topk_pallas.py``). It uses the direct form
(p - c)^2 with every operation rounded on its own, as the kernel does, so
the two agree bit for bit.
"""

from __future__ import annotations

import torch

# entries of the plain version's (points, N) distance matrix at once: its
# points go in chunks of this many over N (256 MB an f32 temporary)
_PLAIN_ENTRIES = 1 << 26


def topk2_fields_plain(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Plain top-2: points (3, P) finite, centres (N, 3), valid (N,) bool ->
    (dists (2, P) f32, idx (2, P) int32): each point's two smallest masked
    squared distances in lexicographic (distance, index) order, the order a
    stable sort gives them. ``argmin`` takes the first of equal minima;
    the first's entry set to +inf, a second ``argmin`` takes the next, and
    where that is +inf every other entry is, so the second is the lowest
    index but the first's. Points go in chunks of ``_PLAIN_ENTRIES``
    matrix entries, so many centres take no more memory than a few."""
    n = centers.shape[0]
    rows = max(1024, _PLAIN_ENTRIES // max(n, 2))
    d_parts, i_parts = [], []
    for s in range(0, points_fm.shape[1], rows):
        pts = points_fm[:, s : s + rows]
        d2 = pts[0][:, None] - centers[:, 0][None, :]
        dy = pts[1][:, None] - centers[:, 1][None, :]
        dz = pts[2][:, None] - centers[:, 2][None, :]
        d2.mul_(d2).add_(dy.mul_(dy)).add_(dz.mul_(dz))  # dx * dx + dy * dy + dz * dz
        del dy, dz
        d2.masked_fill_(~valid[None, :], torch.inf)
        if n < 2:  # fewer centres than neighbours: pad with inf (index clamped)
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], 2 - n), torch.inf)], dim=1)
        first = torch.argmin(d2, dim=1, keepdim=True)
        d_first = torch.gather(d2, 1, first)
        d2.scatter_(1, first, torch.inf)
        second = torch.argmin(d2, dim=1, keepdim=True)
        d_second = torch.gather(d2, 1, second)
        second = torch.where(torch.isinf(d_second), (first == 0).long(), second)
        d_parts.append(torch.sqrt(torch.cat([d_first, d_second], dim=1)).T)
        i_parts.append(torch.clamp(torch.cat([first, second], dim=1), max=n - 1).T.to(torch.int32))
    if not d_parts:
        return points_fm.new_empty((2, 0)), torch.empty((2, 0), dtype=torch.int32, device=points_fm.device)
    return torch.cat(d_parts, dim=1).contiguous(), torch.cat(i_parts, dim=1).contiguous()


def _check_inputs(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor) -> None:
    if points_fm.ndim != 2 or points_fm.shape[0] != 3:
        raise ValueError(f"points must be (3, P), got {tuple(points_fm.shape)}")
    if centers.ndim != 2 or centers.shape[1] != 3 or valid.shape != (centers.shape[0],):
        raise ValueError(f"centres {tuple(centers.shape)} / valid {tuple(valid.shape)}")
    if points_fm.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("points and centres must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if centers.shape[0] < 1:
        raise ValueError("topk2_fields needs at least one centre")


def topk2_fields(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Two nearest valid field centres per point (topk_pallas.topk2_fields):
    points (3, P) f32, centres (N, 3) f32, valid (N,) bool -> (dists (2, P)
    f32, +inf for an invalid winner; idx (2, P) int32, ties to the lower
    index, clamped to N - 1)."""
    _check_inputs(points_fm, centers, valid)
    return topk2_fields_plain(points_fm, centers, valid)
