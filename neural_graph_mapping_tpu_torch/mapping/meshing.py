"""Colored triangle-mesh extraction from the field set (port of
neural_graph_mapping_tpu.mapping.meshing).

The mapped volume (field AABB +- 2 * radius) is split into blocks; the
field set's geometry channel is evaluated on each block's voxel grid, the
isosurface is extracted on the host (native marching tetrahedra), and
vertices are recolored by evaluating the field set again with an enlarged
radius (no black seams at field boundaries). Output: PLY + a
``*_fields.txt`` with field positions.

Field sets the tiled route takes (``supports_tiled_knn``) are evaluated
through ``apply_knn_tiled`` (no drops) on every device: the
``topk2_fields`` and carried ``encode_fwd_moe`` kernels on the card, their
plain versions on the CPU. Other field sets take the capacity-buffer route
``apply_knn`` with ``knn_capacity`` slots a field (on the card through
``gather_pairs``), and dropped pairs are logged.

With the field axis sharded over ranks (``shard``), every rank meshes the
same blocks: the tiled route blends through
``sharding.render_points_sharded`` on this rank's rows, the capacity route
evaluates a full copy gathered once (``sharding.gather_field_tensors``),
and only the caller's rank 0 passes a file path.
"""

from __future__ import annotations

import logging
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from neural_graph_mapping_tpu_torch.ops import native
from neural_graph_mapping_tpu_torch.parallel import sharding
from neural_graph_mapping_tpu_torch.utils import chunking, meshio, transforms

logger = logging.getLogger(__name__)


def geometry_to_volume(geometry_mode: str, volume: np.ndarray, geometry_factor: float):
    """Geometry-mode-specific isolevel handling.

    Returns (volume, isolevel) such that the surface is volume == isolevel
    with 'inside' being *below* the isolevel (our marching tetrahedra's
    convention: inside = value < iso).
    """
    if geometry_mode == "occupancy":
        vol = 1.0 / (1.0 + np.exp(-geometry_factor * volume))
        return -vol, -0.5  # high occupancy is inside
    if geometry_mode == "density":
        return -volume, -30.0  # isolevel 30, high density inside
    if geometry_mode in ("neus", "nrgbd"):
        return volume, 0.0  # signed-distance-like: negative inside
    raise ValueError(f"Unknown geometry_mode {geometry_mode!r}")


def mesh_blocks(active: np.ndarray, field_radius: float, resolution: float, block_size: int):
    """The voxel grid over the active fields' AABB +- 2 * radius, in blocks
    of ``block_size`` voxels a side (neighbours share their boundary plane).
    Yields (bx, by, bz, points): each block's axes and its (X * Y * Z, 3)
    float32 grid points, or None for a block no field sphere touches."""
    bb_min = active.min(axis=0) - 2 * field_radius
    bb_max = active.max(axis=0) + 2 * field_radius
    axes = [np.arange(bb_min[d], bb_max[d], resolution, dtype=np.float32) for d in range(3)]
    for xs0 in range(0, max(len(axes[0]) - 1, 1), block_size):
        for ys0 in range(0, max(len(axes[1]) - 1, 1), block_size):
            for zs0 in range(0, max(len(axes[2]) - 1, 1), block_size):
                bx = axes[0][xs0 : xs0 + block_size + 1]
                by = axes[1][ys0 : ys0 + block_size + 1]
                bz = axes[2][zs0 : zs0 + block_size + 1]
                if len(bx) < 2 or len(by) < 2 or len(bz) < 2:
                    continue
                # quick reject: does any field sphere touch this block?
                blk_min = np.array([bx[0], by[0], bz[0]]) - field_radius
                blk_max = np.array([bx[-1], by[-1], bz[-1]]) + field_radius
                touching = ((active >= blk_min[None]) & (active <= blk_max[None])).all(-1)
                if not touching.any():
                    yield bx, by, bz, None
                    continue
                gx, gy, gz = np.meshgrid(bx, by, bz, indexing="ij")
                yield bx, by, bz, np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)


def extract_mesh(
    fset,
    params,
    field_positions: torch.Tensor,
    field_orientations: torch.Tensor,
    field_valid: torch.Tensor,
    field_radius: float,
    geometry_mode: str,
    geometry_factor: float,
    color_factor: float = 1.0,
    resolution: float = 0.02,
    threshold: Optional[float] = None,
    transform: Optional[np.ndarray] = None,
    block_size: int = 128,
    eval_chunk: int = 262144,
    knn_capacity: int = 32768,
    mesh_file_path: Optional[pathlib.Path] = None,
    stats: Optional[dict] = None,
    shard: Optional[sharding.FieldGroup] = None,
) -> Optional[meshio.Mesh]:
    """Extract the colored isosurface mesh of the current map.

    Args:
        fset / params: the NeuralFieldSet and its stacked params (this
            rank's rows with ``shard``).
        field_*: map registry tensors (+ validity over padded capacity), on
            the device the points are evaluated on.
        resolution: voxel size in meters.
        transform: optional 4x4 applied to field poses first (gt_from_est).
        block_size: voxels per block edge.
        eval_chunk: points per field-set call.
        knn_capacity: slots a field of the capacity route (field sets the
            tiled route cannot take).
        mesh_file_path: if given, saves PLY + ``*_fields.txt``.
        stats: if given, filled with ``eval_s`` (field evaluation, the
            device's part, host clock up to the copy back), ``march_s``
            (host marching tetrahedra), ``blocks``, ``blocks_evaluated`` and
            ``dropped_pairs`` (the capacity route's; 0 on the tiled route).
        shard: the field axis's process group when ``params`` are sharded;
            every rank must call with the same map.

    Returns:
        The extracted mesh (None if no surface crossed).
    """
    device = field_positions.device
    positions = field_positions.detach().cpu().numpy()
    orientations = field_orientations.detach().cpu().numpy()
    valid = field_valid.detach().cpu().numpy()
    if transform is not None:
        t = np.asarray(transform, np.float32)
        positions = positions @ t[:3, :3].T + t[:3, 3]
        orientations = transforms.transform_quaternions(
            torch.from_numpy(orientations), torch.from_numpy(t)
        ).numpy()
    timing = stats if stats is not None else {}
    timing.update(eval_s=0.0, march_s=0.0, blocks=0, blocks_evaluated=0, dropped_pairs=0)
    active = positions[valid]
    if len(active) == 0:
        return None
    positions_t = torch.from_numpy(np.ascontiguousarray(positions, np.float32)).to(device)
    orientations_t = torch.from_numpy(np.ascontiguousarray(orientations, np.float32)).to(device)
    valid_t = torch.from_numpy(valid).to(device)
    use_tiled = fset.supports_tiled_knn()
    if shard is not None and not use_tiled:
        params = sharding.gather_field_tensors(params, shard)

    def eval_points(pts: np.ndarray, radius: float) -> np.ndarray:
        """Chunked KNN evaluation of (N, 3) world points -> (N, 4)."""
        t0 = time.perf_counter()
        drop_counts = []

        def model(chunk):
            if use_tiled and shard is not None:
                return sharding.render_points_sharded(
                    fset, params, positions_t, orientations_t, valid_t, chunk, shard, field_radius=radius
                )
            if use_tiled:
                return fset.apply_knn_tiled(
                    params, chunk, positions_t, orientations_t, valid_t, field_radius=radius
                )
            out, dropped = fset.apply_knn(
                params, chunk, positions_t, orientations_t, valid_t, capacity=knn_capacity,
                field_radius=radius, with_stats=True,
            )
            drop_counts.append(dropped)
            return out

        out = chunking.batched_evaluation(model, torch.from_numpy(pts).to(device), eval_chunk)
        result = out.detach().cpu().numpy()
        timing["dropped_pairs"] += chunking.warn_dropped_pairs(drop_counts, logger, "meshing", knn_capacity)
        timing["eval_s"] += time.perf_counter() - t0
        return result

    all_verts, all_faces, all_colors = [], [], []
    vert_offset = 0

    for bx, by, bz, pts in mesh_blocks(active, field_radius, resolution, block_size):
        timing["blocks"] += 1
        if pts is None:
            continue
        timing["blocks_evaluated"] += 1
        geo = eval_points(pts, field_radius)[:, 3].reshape(len(bx), len(by), len(bz))
        if not np.isfinite(geo).all():
            logger.warning("non-finite volume in mesh block; clamping")
            geo = np.nan_to_num(geo, nan=1.0, posinf=1.0, neginf=-1.0)
        vol, iso = geometry_to_volume(geometry_mode, geo, geometry_factor)
        if threshold is not None:
            iso = threshold
        t0 = time.perf_counter()
        verts, tris = native.marching_tetrahedra(vol, iso)
        timing["march_s"] += time.perf_counter() - t0
        if len(verts) == 0:
            continue
        # grid-index -> world coordinates
        verts_w = np.stack(
            [
                bx[0] + verts[:, 0] * resolution,
                by[0] + verts[:, 1] * resolution,
                bz[0] + verts[:, 2] * resolution,
            ],
            axis=-1,
        ).astype(np.float32)
        colors = eval_points(verts_w, field_radius + 0.1)[:, :3]
        colors = np.clip(color_factor * colors, 0.0, 1.0)

        all_verts.append(verts_w)
        all_faces.append(tris + vert_offset)
        all_colors.append(colors)
        vert_offset += len(verts_w)

    if not all_verts:
        logger.warning("could not extract mesh: not crossing isosurface")
        return None

    mesh = meshio.Mesh(
        np.concatenate(all_verts),
        np.concatenate(all_faces),
        np.concatenate(all_colors),
    )
    if mesh_file_path is not None:
        mesh_file_path = pathlib.Path(mesh_file_path)
        meshio.save_ply(mesh_file_path, mesh)
        np.savetxt(mesh_file_path.with_name(mesh_file_path.stem + "_fields.txt"), active)
    return mesh
