"""Point -> field dispatch for the inference paths (port of
neural_graph_mapping_tpu.ops.dispatch: ``topk_fields`` and
``tiled_dispatch_sorted``).

Fields are experts and (point, neighbour) pairs are tokens. The tiled
route sorts pairs by field and packs them into TILE-pair tiles that each
belong to one field, the layout the MoE encode kernels take. The port keeps
the JAX functions' semantics and outputs, not their TPU workarounds: one
stable sort of the ids and gathers of the payloads by the returned order,
and segment starts by binary searches in the sorted ids (no (M, N) compare
matrix, and no host sync: ``torch.bincount`` on a CUDA tensor reads its
maximum on the host to size its output).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Entries of topk_fields' (P, N) distance matrix computed at once (1 GB):
# the points are taken in row chunks of this many entries.
TOPK_CHUNK_ENTRIES = 1 << 28


def topk_fields(
    points: torch.Tensor,  # (P, 3)
    centers: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest valid field centres per point, brute force over all
    centres -> (dists (P, k) euclidean, +inf for invalid; idx (P, k) int32).

    Squared distances in the expanded form |p|^2 + |c|^2 - 2 p.c, as the JAX
    function computes them; ties go to the lower index (iterated argmin for
    k <= 4, a stable sort above); fewer centres than k pad with inf and the
    last index. Rows are independent: the points go in chunks of
    ``TOPK_CHUNK_ENTRIES`` distance-matrix entries, so a render block's
    millions of points never hold the whole (P, N) matrix.
    """
    rows = max(1024, TOPK_CHUNK_ENTRIES // max(centers.shape[0], k))
    if points.shape[0] > rows:
        parts = [_topk_fields(points[s : s + rows], centers, valid, k) for s in range(0, points.shape[0], rows)]
        return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])
    return _topk_fields(points, centers, valid, k)


def _topk_fields(points, centers, valid, k):
    p_sq = torch.sum(points**2, dim=-1, keepdim=True)  # (P, 1)
    c_sq = torch.sum(centers**2, dim=-1)  # (N,)
    d_sq = p_sq + c_sq[None, :] - 2.0 * points @ centers.T
    d_sq = torch.where(valid[None, :], d_sq, torch.inf)
    n = d_sq.shape[-1]
    if k > n:
        d_sq = torch.cat([d_sq, d_sq.new_full((d_sq.shape[0], k - n), torch.inf)], dim=-1)
    if k <= 4:
        lanes = torch.arange(d_sq.shape[-1], device=d_sq.device)[None, :]
        vals, idxs = [], []
        run = d_sq
        for _ in range(k):
            vals.append(torch.amin(run, dim=-1))
            i = torch.argmin(run, dim=-1)
            idxs.append(i)
            run = torch.where(lanes == i[:, None], torch.inf, run)
        vals_t = torch.stack(vals, dim=-1)
        idx = torch.stack(idxs, dim=-1)
    else:
        vals_t, idx = torch.sort(d_sq, dim=-1, stable=True)
        vals_t, idx = vals_t[:, :k], idx[:, :k]
    idx = torch.clamp(idx, max=centers.shape[0] - 1).to(torch.int32)
    return torch.sqrt(torch.clamp(vals_t, min=0.0)), idx


def tiled_dispatch_sorted(
    expert_ids: torch.Tensor,  # (M,) int
    pair_valid: torch.Tensor,  # (M,) bool
    payloads: Sequence[torch.Tensor],  # (M,) arrays co-sorted with the ids
    num_experts: int,
    tile: int,
):
    """Sort-based tile dispatch (dispatch.tiled_dispatch_sorted).

    Invalid pairs sort into a trailing group (key ``num_experts``) whose
    tiles map to expert ``num_experts - 1``; each expert's (and the invalid
    group's) segment is padded to whole tiles, so the tile buffer fills with
    per-tile contiguous slices ``sorted[tile_src[t] : tile_src[t] + tile]``.

    Returns, as the JAX function:
        sorted_payloads: tuple of (M,) arrays, expert-sorted (stable).
        orig_idx: (M,) int32 original pair index per sorted position.
        tile_src: (num_tiles,) int32 start into the sorted arrays per tile,
            clipped to [0, M] (callers pad the sorted arrays by one tile).
        tile_expert: (num_tiles,) int32 owning expert (invalid and dead
            tiles clipped to num_experts - 1).
        tile_count: (num_tiles,) int32 real lanes per tile.
        num_live_tiles: () int32 tensor, tiles holding valid pairs.
        num_tiles: int, ceil(M / tile) + num_experts + 1.
    """
    m = expert_ids.shape[0]
    dev = expert_ids.device
    num_tiles = -(-m // tile) + num_experts + 1
    ids = torch.where(pair_valid, expert_ids.long(), num_experts)
    sorted_ids, order = torch.sort(ids, stable=True)
    sorted_payloads = tuple(p[order] for p in payloads)
    orig_idx = order.to(torch.int32)

    # seg_start[g] = #ids below group g, g = 0..N+1 (N = the invalid group)
    groups = torch.arange(num_experts + 2, device=dev, dtype=sorted_ids.dtype)
    seg_start = torch.searchsorted(sorted_ids, groups)  # (N+2,)
    counts = seg_start[1:] - seg_start[:-1]  # (N+1,) incl. invalid group
    padded = (counts + tile - 1) // tile * tile
    pad_start = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])  # (N+2,)

    t_start = torch.arange(num_tiles, device=dev, dtype=torch.int64) * tile
    group = torch.clamp(torch.searchsorted(pad_start, t_start, right=True) - 1, 0, num_experts)
    raw_src = t_start - (pad_start[group] - seg_start[group])
    tile_count = torch.clamp(seg_start[group + 1] - raw_src, 0, tile)
    tile_src = torch.clamp(raw_src, 0, m)
    tile_expert = torch.clamp(group, max=num_experts - 1)
    num_live_tiles = (pad_start[num_experts] // tile).to(torch.int32)
    return (
        sorted_payloads, orig_idx, tile_src.to(torch.int32), tile_expert.to(torch.int32),
        tile_count.to(torch.int32), num_live_tiles, num_tiles,
    )

