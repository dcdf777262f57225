"""CO-SLAM-style mesh culling for fair reconstruction evaluation (port of
neural_graph_mapping_tpu.eval.culling; host numpy).

Rebuild of the reference ``mesh_culling.py`` (itself adapted from
JingwenWang95/neural_slam_eval): subdivide the mesh to a max edge length, cull
triangles outside the scene bounds, render double-sided depth maps from every
2nd GT pose (+ optional virtual cameras), and keep only triangles that are
inside at least one real-camera frustum AND unoccluded in at least one view.

Depth rendering uses the native C++ rasterizer
(:mod:`neural_graph_mapping_tpu_torch.ops.native`) instead of pyrender/EGL; the
per-vertex frustum/occlusion tests run vectorized in numpy (they are offline
eval, not hot path).
"""

from __future__ import annotations

import glob
import logging
import os
import pathlib
from typing import List, Optional

import numpy as np

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.ops import native
from neural_graph_mapping_tpu_torch.utils.meshio import Mesh

logger = logging.getLogger(__name__)

CULLING_METHODS = ("virt_cams", "occlusion", "frustum")


def load_virt_cam_poses(path: pathlib.Path) -> List[np.ndarray]:
    """Virtual camera poses stored as per-file 4x4 OpenCV c2w txts
    (mesh_culling.py:23-38); converted to OpenGL."""
    poses = []
    for pose_path in sorted(
        glob.glob(os.path.join(path, "*.txt")),
        key=lambda x: int(os.path.basename(x)[:-4]),
    ):
        c2w = np.loadtxt(pose_path).reshape(4, 4)
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        poses.append(c2w.astype(np.float32))
    logger.info("added %d virtual views from %s", len(poses), path)
    return poses


def render_depth_maps(
    mesh: Mesh, poses_c2w_gl: List[np.ndarray], cam: Camera, far: float = 10.0
) -> np.ndarray:
    """Double-sided depth maps from OpenGL c2w poses (mesh_culling.py:41-120).

    The native rasterizer is already double-sided, so no two-pass flip.
    """
    fx, fy, cx, cy, _ = cam.get_pinhole_camera_parameters(0.5)
    depths = np.zeros((len(poses_c2w_gl), cam.height, cam.width), np.float32)
    for i, c2w in enumerate(poses_c2w_gl):
        c2w_cv = c2w.copy()
        c2w_cv[:3, 1] *= -1  # OpenGL -> OpenCV
        c2w_cv[:3, 2] *= -1
        w2c = np.linalg.inv(c2w_cv).astype(np.float32)
        d = native.rasterize_depth(
            mesh.vertices, mesh.faces, w2c, fx, fy, cx, cy, cam.width, cam.height
        )
        d[d > far] = 0.0
        depths[i] = d
    return depths


def cull_by_bounds(points: np.ndarray, bounds: np.ndarray, eps: float = 0.02):
    """AABB inclusion mask (mesh_culling.py:123-140)."""
    return np.all(points >= bounds[0] - eps, axis=1) & np.all(
        points <= bounds[1] + eps, axis=1
    )


def _per_pose_masks(
    points: np.ndarray,
    c2w_gl: np.ndarray,
    cam: Camera,
    rendered_depth: Optional[np.ndarray],
    eps: float = 0.03,
):
    """Frustum + occlusion masks for one pose (mesh_culling.py:143-190)."""
    c2w = c2w_gl.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    w2c = np.linalg.inv(c2w)
    cam_pts = points @ w2c[:3, :3].T + w2c[:3, 3]
    fx, fy, cx, cy, _ = cam.get_pinhole_camera_parameters(0.5)
    pz = cam_pts[:, 2] + 1e-8
    px = fx * cam_pts[:, 0] / pz + cx
    py = fy * cam_pts[:, 1] / pz + cy
    in_frustum = (
        (px >= 0) & (px <= cam.width - 1) & (py >= 0) & (py <= cam.height - 1) & (pz > 0)
    )
    if rendered_depth is None:
        return in_frustum, in_frustum
    u = np.clip(px, 0, cam.width - 1).astype(np.int32)
    v = np.clip(py, 0, cam.height - 1).astype(np.int32)
    obs = in_frustum & (pz < rendered_depth[v, u] + eps)
    return in_frustum, obs


def cull_mesh(
    mesh: Mesh,
    dataset,
    culling_method: str,
    subdivide: bool = True,
    max_edge: float = 0.1,
    eps: float = 0.03,
    pose_stride: int = 2,
) -> Mesh:
    """Cull a mesh per the CO-SLAM protocol (mesh_culling.py:228-385).

    Args:
        mesh: mesh to cull (world frame, aligned with GT).
        dataset: provides gt_c2ws, camera, scene bounds, virtual_cameras dir.
        culling_method: "virt_cams" | "occlusion" | "frustum".
    """
    if culling_method not in CULLING_METHODS:
        raise ValueError(f"Unknown culling method {culling_method}")
    remove_occlusion = culling_method in ("virt_cams", "occlusion")
    use_virtual = culling_method == "virt_cams"

    cam = dataset.camera.scaled_camera(0.5)
    if subdivide:
        mesh = mesh.subdivide_to_size(max_edge)

    vertices = mesh.vertices
    triangles = mesh.faces

    # bounds culling (any-vertex-inside keeps a triangle, :282-289)
    bounds = dataset.custom_scene_bounds
    auto = dataset.scene_bounds
    if bounds is not None and auto is not None:
        bounds = np.stack(
            [np.maximum(bounds[0], auto[0]), np.minimum(bounds[1], auto[1])]
        )
    elif bounds is None:
        bounds = auto
    if bounds is not None:
        inside = cull_by_bounds(vertices, np.asarray(bounds))
        keep = inside[triangles[:, 0]] | inside[triangles[:, 1]] | inside[triangles[:, 2]]
        triangles = triangles[keep]
    else:
        logger.info("no scene bounds available; skipping bounds culling")

    poses = [
        p.astype(np.float32)
        for p in np.asarray(dataset.gt_c2ws)[::pose_stride]
        if np.isfinite(p).all()
    ]
    virt_start = -1
    if use_virtual:
        virt_start = len(poses)
        virt_dir = dataset.scene_dir_path / "virtual_cameras"
        if virt_dir.is_dir():
            poses = poses + load_virt_cam_poses(virt_dir)
        else:
            logger.warning("virtual_cameras dir missing at %s", virt_dir)

    work_mesh = Mesh(vertices, triangles)
    depth_maps = (
        render_depth_maps(work_mesh, poses, cam) if remove_occlusion else None
    )

    in_frustum_count = np.zeros(len(vertices), np.int32)
    obs_count = np.zeros(len(vertices), np.int32)
    for i, pose in enumerate(poses):
        depth_i = depth_maps[i] if depth_maps is not None else None
        in_frustum, obs = _per_pose_masks(vertices, pose, cam, depth_i, eps)
        obs_count += obs
        # virtual views only extend obs, not in_frustum (:220-223)
        if virt_start < 0 or i < virt_start:
            in_frustum_count += in_frustum

    th_obs = 0
    tri_frustum = (
        (in_frustum_count[triangles[:, 0]] > th_obs)
        | (in_frustum_count[triangles[:, 1]] > th_obs)
        | (in_frustum_count[triangles[:, 2]] > th_obs)
    )
    if remove_occlusion:
        tri_obs = (
            (obs_count[triangles[:, 0]] > th_obs)
            | (obs_count[triangles[:, 1]] > th_obs)
            | (obs_count[triangles[:, 2]] > th_obs)
        )
        valid = tri_frustum & tri_obs
    else:
        valid = tri_frustum

    return Mesh(vertices, triangles[valid], mesh.vertex_colors)


def evaluate_raw_mesh(
    est_mesh: Mesh,
    dataset,
    culling_method: str = "virt_cams",
    align: bool = True,
    num_points: int = 200000,
) -> dict:
    """Full mesh-eval pipeline (reference evaluation.py:211-251): cull the GT
    mesh, optionally ICP-align the estimate to it, cull the estimate, compare."""
    from neural_graph_mapping_tpu_torch.eval import mesh_metrics

    gt_mesh = dataset.load_gt_mesh()
    gt_culled = cull_mesh(gt_mesh, dataset, culling_method)
    if len(gt_culled.faces) == 0:
        logger.error(
            "GT mesh has no faces after %s culling; skipping mesh eval "
            "(check camera conventions / virtual_cameras dir)", culling_method
        )
        return {}
    if align:
        est_mesh = mesh_metrics.align_mesh(est_mesh, gt_culled)
    est_culled = cull_mesh(est_mesh, dataset, culling_method)
    if len(est_culled.faces) == 0:
        logger.error(
            "estimated mesh has no faces after %s culling; skipping mesh eval",
            culling_method,
        )
        return {}
    return mesh_metrics.evaluate_meshes(
        est_culled, gt_culled, num_points=num_points, align=False
    )
