"""Operations and bytes that a call's inputs need, and the least time the
card could take for them: the yardstick of every roofline and mfu share.

Copied from ``chip_smoke.py`` (``bound``, ``LATTICE_OPS``,
``encode_bwd_table_bound``, ``moe_bound``), with one change: the MoE encode
counts the pairs its inputs route inside a field's radius, not the lanes
of the tiles the dispatch padded them into. Each input byte is counted read
once and each output byte written once; where the work depends on the data
the count is of what these inputs need, never of what a kernel chose to
evaluate. Counts are device tensors where they depend on values, so a
traced window syncs nothing to take them.
"""

from __future__ import annotations

import math

import torch

# Published peaks of one NVIDIA H100 SXM (data sheet, dense): HBM3 bytes/s
# and float32 operations/s outside the tensor cores. The port computes in
# float32 and leaves TF32 off.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of one point at one lattice level, counted from csrc/permuto.cu
# lattice_level + encode_point: 74 f32 (scale/shift/elevate 18, round and
# remainders 20, barycentric 18, blend 16, sums 2) and 54 integer (ranks 12,
# fix-up 12, hashes of 4 corners 30).
LATTICE_OPS = 128
# Adding one point's cotangent at one level into the 4 corners' 2 features.
SCATTER_OPS = 16
# The ray encode's rebuild of a sample point from its pair index and distance.
RAY_REBUILD_OPS = 40
F32 = 4


def least_seconds(n_bytes, n_ops):
    """The least time for work that moves ``n_bytes`` and does ``n_ops``:
    the larger of the two over their peaks."""
    return max(float(n_bytes) / HBM_BYTES_PER_S, float(n_ops) / F32_OPS_PER_S)


def mlp_flops(widths) -> tuple:
    """(forward, backward) FLOPs of one point through a stack of dense
    layers ``widths`` = (in, hidden..., out): 2 a multiply-add forward, twice
    that backward (input and weight gradients)."""
    fwd = sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    return fwd, 2 * fwd


def encode_fwd(table: torch.Tensor, coords: torch.Tensor) -> dict:
    """encode_fwd(table (..., 2, L, T), coords (..., 3, P)): table and
    coordinates in, (..., 2L, P) features out; the lattice at every point
    and level."""
    n_levels = table.shape[-2]
    points = coords.numel() // 3
    return {"bytes": (table.numel() + coords.numel() + points * 2 * n_levels) * F32,
            "ops": points * n_levels * LATTICE_OPS, "points": points}


def encode_bwd_table(coords: torch.Tensor, g: torch.Tensor, n_levels: int, t: int) -> dict:
    """encode_bwd_table(coords (..., 3, P), g (..., 2L, P)): coordinates and
    cotangent in, the (..., 2, L, T) table gradient out; the lattice and the
    adds at each (point, level) whose cotangent is not zero (a device
    count)."""
    points = coords.numel() // 3
    fields = points // coords.shape[-1]
    g3 = g.reshape(-1, n_levels, 2, g.shape[-1])
    live = ((g3[:, :, 0] != 0) | (g3[:, :, 1] != 0)).sum()
    return {"bytes": (coords.numel() + g.numel() + fields * 2 * n_levels * t) * F32,
            "ops": live * (LATTICE_OPS + SCATTER_OPS), "points": points}


def moe_rays(pairs, experts, n_levels: int, t: int) -> dict:
    """encode_fwd_moe_rays over ``pairs`` (sample, field) pairs inside a
    field's radius, reading the tables of ``experts`` distinct fields: a
    pair index and a distance in per pair, the tables in once, the features
    out; the ray rebuild and the lattice at every pair and level."""
    return {"bytes": pairs * (4 + 4) + experts * 2 * n_levels * t * F32 + pairs * 2 * n_levels * F32,
            "ops": pairs * (n_levels * LATTICE_OPS + RAY_REBUILD_OPS), "points": pairs}


def routed_pairs(pair_valid: torch.Tensor, tile_expert: torch.Tensor, tile_count: torch.Tensor,
                 num_live_tiles: torch.Tensor, num_experts: int) -> tuple:
    """(valid pairs, distinct fields they route to) of a tiled dispatch, as
    device counts: the pairs its input marks valid, and the fields that own
    a live tile with a pair in it (every valid pair lies in such a tile)."""
    tiles = torch.arange(tile_expert.shape[0], device=tile_expert.device)
    owns = (tiles < num_live_tiles) & (tile_count > 0)
    hit = torch.zeros(num_experts + 1, dtype=torch.bool, device=tile_expert.device)
    hit[torch.where(owns, tile_expert.long(), num_experts)] = True
    return pair_valid.sum(), hit[:num_experts].sum()


def share_pct(bound_s: float, device_s: float):
    """100 x least time / measured time; None where nothing was measured."""
    if device_s <= 0 or not math.isfinite(device_s):
        return None
    return 100.0 * bound_s / device_s
