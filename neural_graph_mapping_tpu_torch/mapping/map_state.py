"""Field/map registry: SoA tensors, grid-based allocation, pose re-anchoring
(port of neural_graph_mapping_tpu.mapping.map_state).

The map is a struct of tensors with a fixed, power-of-two capacity; growth
doubles it, and every consumer works on the full padded tensors with masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from neural_graph_mapping_tpu_torch.utils import transforms


class MapArrays(NamedTuple):
    """Device-side SoA map registry; entries >= num_fields are invalid.
    ``kf_slots`` is each field's anchor keyframe cache slot."""

    positions: torch.Tensor  # (cap, 3) world positions
    orientations: torch.Tensor  # (cap, 4) world orientations, wxyz
    kf_ids: torch.Tensor  # (cap,) anchor keyframe frame-id
    kf_slots: torch.Tensor  # (cap,) anchor keyframe cache slot
    training_iterations: torch.Tensor  # (cap,)


def init_map_arrays(capacity: int = 32, device=None) -> MapArrays:
    orientations = torch.zeros((capacity, 4), device=device)
    orientations[:, 0] = 1.0
    return MapArrays(
        positions=torch.zeros((capacity, 3), device=device),
        orientations=orientations,
        kf_ids=torch.zeros((capacity,), dtype=torch.int32, device=device),
        kf_slots=torch.zeros((capacity,), dtype=torch.int32, device=device),
        training_iterations=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def capacity(arrays: MapArrays) -> int:
    return arrays.positions.shape[0]


def grow_capacity(arrays: MapArrays, required: int) -> MapArrays:
    """Double (repeatedly) the padded capacity until it holds ``required``."""
    cap = capacity(arrays)
    new_cap = cap
    while new_cap < required:
        new_cap *= 2
    if new_cap == cap:
        return arrays
    pad = new_cap - cap

    def pad_leaf(leaf):
        return torch.cat([leaf, torch.zeros((pad,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)])

    grown = MapArrays(*(pad_leaf(leaf) for leaf in arrays))
    grown.orientations[cap:, 0] = 1.0
    return grown


def field_cell_size(field_radius: float) -> float:
    """Grid cell size such that a field at the cell center covers the cell."""
    return 2.0 * field_radius / math.sqrt(3.0)


_CELL_OFFSET = 500
_CELL_BASE = 1001  # 1001**3 < 2**31: codes fit int32, as in the JAX package
_INVALID_CODE = 2**31 - 1


def _cell_code(ijk: torch.Tensor) -> torch.Tensor:
    """Pack integer grid coords (..., 3) into one sortable code."""
    c = torch.clamp(ijk + _CELL_OFFSET, 0, _CELL_BASE - 1)
    return (c[..., 0] * _CELL_BASE + c[..., 1]) * _CELL_BASE + c[..., 2]


def _code_to_cell(code: torch.Tensor) -> torch.Tensor:
    z = code % _CELL_BASE
    y = (code // _CELL_BASE) % _CELL_BASE
    x = code // (_CELL_BASE * _CELL_BASE)
    return torch.stack([x, y, z], dim=-1) - _CELL_OFFSET


def uncovered_cells(
    points_world: torch.Tensor,  # (P, 3)
    points_valid: torch.Tensor,  # (P,)
    field_positions: torch.Tensor,  # (N, 3)
    field_valid: torch.Tensor,  # (N,)
    field_radius: float,
    max_new: int,
    shift: Optional[torch.Tensor] = None,  # (3,) grid shift ~ U(0, cell)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New-field cell centers covering currently-uncovered depth points.

    1. a point is covered if a valid field center lies within field_radius;
    2. uncovered points -> randomly shifted grid cells -> dedupe by sorting;
    3. drop cells that already hold a field center.

    Returns centers (max_new, 3) (padded with zeros) and num_new (int64 scalar
    tensor).
    """
    dev = points_world.device
    cell = field_cell_size(field_radius)
    if shift is None:
        shift = torch.rand((3,), generator=generator, device=dev) * cell

    # -- 1. coverage (chunked over fields to bound the intermediate) ---------
    p_sq = torch.sum(points_world**2, dim=-1)
    min_d_sq = torch.full((points_world.shape[0],), torch.inf, device=dev)
    n = field_positions.shape[0]
    chunk = min(1024, n)
    for start in range(0, n, chunk):
        c_pos = field_positions[start:start + chunk]
        c_val = field_valid[start:start + chunk]
        c_sq = torch.sum(c_pos**2, dim=-1)
        d_sq = p_sq[:, None] + c_sq[None, :] - 2.0 * points_world @ c_pos.T
        d_sq = torch.where(c_val[None, :], d_sq, torch.full_like(d_sq, torch.inf))
        min_d_sq = torch.minimum(min_d_sq, torch.amin(d_sq, dim=-1))
    uncovered = points_valid & (min_d_sq > field_radius**2)

    # -- 2. quantize + dedupe -------------------------------------------------
    ijk = torch.floor((points_world + shift) / cell).long()
    codes = torch.where(uncovered, _cell_code(ijk), torch.full_like(ijk[:, 0], _INVALID_CODE))
    codes = torch.sort(codes).values
    is_first = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), codes[1:] != codes[:-1]]
    ) & (codes < _INVALID_CODE)

    # -- 3. exclude cells already holding a field ------------------------------
    f_ijk = torch.floor((field_positions + shift) / cell).long()
    f_codes = torch.where(field_valid, _cell_code(f_ijk), torch.full_like(f_ijk[:, 0], _INVALID_CODE))
    f_codes = torch.sort(f_codes).values
    pos = torch.searchsorted(f_codes, codes)
    already = f_codes[torch.clamp(pos, 0, f_codes.shape[0] - 1)] == codes
    fresh = is_first & ~already

    # compact the first max_new fresh codes into the output
    order = torch.cumsum(fresh.long(), 0) - 1
    dest = torch.where(fresh & (order < max_new), order, torch.full_like(order, max_new))
    out_codes = torch.full((max_new + 1,), _INVALID_CODE, dtype=torch.int64, device=dev)
    out_codes.scatter_(0, dest, codes)
    out_codes = out_codes[:max_new]
    num_new = torch.clamp(torch.sum(fresh), max=max_new)

    centers = (_code_to_cell(out_codes).float() + 0.5) * cell - shift
    valid_rows = torch.arange(max_new, device=dev) < num_new
    centers = torch.where(valid_rows[:, None], centers, torch.zeros_like(centers))
    return centers, num_new


def reanchor_field_poses(
    arrays: MapArrays, prev_kf2w_slots: torch.Tensor, new_kf2w_slots: torch.Tensor
) -> MapArrays:
    """Loop-closure map deformation: each field moves by
    ``T_f = new_kf2w[slot_f] @ inv(prev_kf2w[slot_f])`` of its anchor slot."""
    slots = arrays.kf_slots.long()
    prev = prev_kf2w_slots[slots]  # (cap, 4, 4)
    new = new_kf2w_slots[slots]
    delta = new @ transforms.invert_rigid(prev)
    # keyframes with NaN poses (tracking lost) leave fields untouched
    ok = torch.isfinite(delta.reshape(delta.shape[0], -1)).all(dim=-1)
    new_pos = transforms.transform_points(arrays.positions, delta)
    new_quat = transforms.transform_quaternions(arrays.orientations, delta)
    return arrays._replace(
        positions=torch.where(ok[:, None], new_pos, arrays.positions),
        orientations=torch.where(ok[:, None], new_quat, arrays.orientations),
    )


def append_fields(
    arrays: MapArrays,
    num_existing: int,
    centers: torch.Tensor,  # (max_new, 3)
    num_new: int,
    frame_id: int,
    kf_slot: int,
) -> MapArrays:
    """Write ``num_new`` freshly allocated fields after ``num_existing``
    (in place; the capacity must already hold them)."""
    end = num_existing + num_new
    if end > capacity(arrays):
        raise ValueError(f"{end} fields exceed capacity {capacity(arrays)}")
    arrays.positions[num_existing:end] = centers[:num_new]
    arrays.orientations[num_existing:end] = torch.tensor(
        [1.0, 0.0, 0.0, 0.0], device=centers.device
    )
    arrays.kf_ids[num_existing:end] = frame_id
    arrays.kf_slots[num_existing:end] = kf_slot
    arrays.training_iterations[num_existing:end] = 0
    return arrays
