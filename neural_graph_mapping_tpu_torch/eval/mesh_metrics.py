"""Mesh reconstruction metrics + ICP alignment, CO-SLAM protocol (port of
neural_graph_mapping_tpu.eval.mesh_metrics; host numpy).

Rebuild of the reference ``evaluation.py:65-251``: sample surface points from
the estimated and ground-truth meshes, compute accuracy/completion
(mean + median), accuracy/completion ratios at 5 cm and 1 cm, and the
reconstruction F1 scores; optionally point-to-plane ICP-align the estimated
mesh to the culled GT mesh first (evaluation.py:133-160, replacing open3d's
registration_icp with a small host-side Gauss-Newton solver).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
from scipy.spatial import cKDTree

from neural_graph_mapping_tpu_torch.utils.meshio import Mesh

logger = logging.getLogger(__name__)


def accuracy_completion_metrics(
    est_points: np.ndarray,
    gt_points: np.ndarray,
    thresholds=(0.05, 0.01),
) -> Dict[str, float]:
    """Point-set distances (reference evaluation.py:65-130, 197-208).

    accuracy: est -> gt distances; completion: gt -> est distances.
    """
    gt_tree = cKDTree(gt_points)
    est_tree = cKDTree(est_points)
    acc_d, _ = gt_tree.query(est_points, k=1)
    comp_d, _ = est_tree.query(gt_points, k=1)

    metrics = {
        "accuracy": float(acc_d.mean()),
        "accuracy_median": float(np.median(acc_d)),
        "completion": float(comp_d.mean()),
        "completion_median": float(np.median(comp_d)),
    }
    for t in thresholds:
        cm = int(round(t * 100))
        acc_ratio = float((acc_d < t).mean())
        comp_ratio = float((comp_d < t).mean())
        f1 = (
            2 * acc_ratio * comp_ratio / (acc_ratio + comp_ratio)
            if acc_ratio + comp_ratio > 0
            else 0.0
        )
        metrics[f"accuracy_ratio_{cm}cm"] = acc_ratio
        metrics[f"completion_ratio_{cm}cm"] = comp_ratio
        metrics[f"f1_{cm}cm"] = f1
    return metrics


def icp_point_to_plane(
    source_points: np.ndarray,
    target_points: np.ndarray,
    target_normals: np.ndarray,
    max_iterations: int = 30,
    max_corr_dist: float = 0.1,
    tol: float = 1e-7,
) -> np.ndarray:
    """Point-to-plane ICP: returns 4x4 aligning source -> target.

    Small-angle Gauss-Newton on the 6-dof twist, standard formulation
    (replaces open3d TransformationEstimationPointToPlane,
    evaluation.py:149-156).
    """
    tree = cKDTree(target_points)
    transform = np.eye(4)
    src = source_points.copy()
    prev_err = np.inf
    for _ in range(max_iterations):
        d, idx = tree.query(src, k=1, distance_upper_bound=max_corr_dist)
        ok = np.isfinite(d)
        if ok.sum() < 6:
            break
        p = src[ok]
        q = target_points[idx[ok]]
        n = target_normals[idx[ok]]
        r = np.einsum("ij,ij->i", p - q, n)  # residuals
        err = float(np.mean(r**2))
        # jacobian rows: [cross(p, n), n]
        j = np.concatenate([np.cross(p, n), n], axis=1)  # (M, 6)
        h = j.T @ j
        g = j.T @ r
        try:
            delta = np.linalg.solve(h + 1e-9 * np.eye(6), -g)
        except np.linalg.LinAlgError:
            break
        rx, ry, rz, tx, ty, tz = delta
        c = np.array(
            [
                [1.0, -rz, ry, tx],
                [rz, 1.0, -rx, ty],
                [-ry, rx, 1.0, tz],
                [0.0, 0.0, 0.0, 1.0],
            ]
        )
        # re-orthonormalize the rotation block
        u, _, vt = np.linalg.svd(c[:3, :3])
        c[:3, :3] = u @ vt
        src = src @ c[:3, :3].T + c[:3, 3]
        transform = c @ transform
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return transform


def align_mesh(
    est_mesh: Mesh, gt_mesh: Mesh, num_points: int = 100000, seed: int = 0
) -> Mesh:
    """ICP-align est mesh to gt mesh (reference _align_mesh,
    evaluation.py:133-160)."""
    est_pts, _ = est_mesh.sample_surface(num_points, seed)
    gt_pts, gt_face_idx = gt_mesh.sample_surface(num_points, seed + 1)
    gt_normals = gt_mesh.face_normals()[gt_face_idx]
    t = icp_point_to_plane(est_pts, gt_pts, gt_normals)
    return est_mesh.transform(t)


def evaluate_meshes(
    est_mesh: Mesh,
    gt_mesh: Mesh,
    num_points: int = 200000,
    align: bool = True,
    seed: int = 0,
) -> Dict[str, float]:
    """Sample 2x num_points and compare (reference
    _evaluate_postprocessed_meshes, evaluation.py:163-208)."""
    if align:
        est_mesh = align_mesh(est_mesh, gt_mesh)
    est_pts, _ = est_mesh.sample_surface(num_points, seed)
    gt_pts, _ = gt_mesh.sample_surface(num_points, seed + 1)
    return accuracy_completion_metrics(est_pts, gt_pts)
