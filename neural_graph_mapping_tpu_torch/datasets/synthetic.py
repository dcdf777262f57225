"""Procedural synthetic RGB-D dataset: analytic sphere scene + orbit camera
(port of neural_graph_mapping_tpu.datasets.synthetic; numpy host code).

Our fixed-seed "fake backend": the reference's mechanism for testing the
mapping system without a SLAM system is pose_source="gt" +
pg_source="fixed_kf_freq" (slam_dataset.py:149-166, 407-422); this dataset
goes one step further and also synthesizes the imagery, so the full online
pipeline (allocation, multi-view sampling, optimization, rendering, meshing,
loop-closure re-anchoring) is testable and benchmarkable hermetically.

Two scene archetypes selected by the ``scene`` config key:

- ``"spheres"`` (default, alias ``"synthetic"``): a few colored spheres
  inside a box room — smooth blobs, the benign case.
- ``"thin"``: thin structures + a concave corner — a floating 4 cm tabletop,
  two 4 cm-radius floor-to-ceiling poles, an L-shaped interior wall pair
  meeting at a right angle, and one small sphere. These are the NRGBD scene
  archetypes (thin chair legs / table edges / room corners) that stress the
  silhouette-halo failure mode of the occupancy-bell formulation and mesh
  metrics; the spheres scene alone cannot falsify halo conclusions.

The camera orbits the center looking inward; depth and color are computed by
exact ray casting (spheres, finite AABBs, finite cylinders, inward walls).
"""

from __future__ import annotations

import pathlib
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.base import SLAMDataset


def _look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL c2w: camera looks along -z."""
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


class SyntheticDataset(SLAMDataset):
    """Analytic RGB-D sequence with ground-truth poses."""

    default_config = dict(
        SLAMDataset.default_config,
        pose_source="gt",
        pg_source="fixed_kf_freq",
        num_frames=60,
        width=80,
        height=60,
        fx=70.0,
        fy=70.0,
        orbit_radius=2.5,
        room_half=3.0,
        drift=0.0,
        seed=0,
    )

    def __init__(self, config: Optional[dict] = None) -> None:
        super().__init__(config or {})
        c = self.config
        self._n = int(c["num_frames"])
        w, h = int(c["width"]), int(c["height"])
        self.camera = Camera.create(
            width=w, height=h, fx=float(c["fx"]), fy=float(c["fy"]),
            cx=w / 2.0, cy=h / 2.0,
        )
        self._room_half = float(c["room_half"])
        archetype = c.get("scene") or "spheres"
        if archetype in ("", "synthetic", "spheres"):
            # spheres: centers, radii, base colors
            self._sphere_c = np.array(
                [[0.0, 0.0, 0.0], [1.2, 0.4, -0.6], [-1.0, -0.3, 0.8]], np.float32
            )
            self._sphere_r = np.array([0.6, 0.45, 0.5], np.float32)
            self._sphere_col = np.array(
                [[0.9, 0.2, 0.2], [0.2, 0.9, 0.3], [0.25, 0.35, 0.95]], np.float32
            )
            self._boxes = []
            self._cyls = []
        elif archetype == "thin":
            self._sphere_c = np.array([[0.1, 0.5, -0.4]], np.float32)
            self._sphere_r = np.array([0.25], np.float32)
            self._sphere_col = np.array([[0.9, 0.2, 0.2]], np.float32)
            # finite AABBs: (bmin, bmax, color)
            self._boxes = [
                # floating 4 cm tabletop: large silhouette depth gap to the wall
                (np.array([0.3, -0.02, 0.2], np.float32),
                 np.array([1.3, 0.02, 1.0], np.float32),
                 np.array([0.85, 0.65, 0.25], np.float32)),
                # L-shaped interior wall pair meeting at a concave right angle
                (np.array([-1.2, -1.2, -1.2], np.float32),
                 np.array([-1.15, 1.2, 0.6], np.float32),
                 np.array([0.3, 0.75, 0.35], np.float32)),
                (np.array([-1.2, -1.2, -1.2], np.float32),
                 np.array([0.6, 1.2, -1.15], np.float32),
                 np.array([0.35, 0.45, 0.85], np.float32)),
            ]
            # thin floor-to-ceiling poles: (center_xz, radius, color)
            self._cyls = [
                (np.array([0.8, -0.5], np.float32), 0.04,
                 np.array([0.9, 0.55, 0.8], np.float32)),
                (np.array([-0.3, 1.0], np.float32), 0.04,
                 np.array([0.5, 0.85, 0.9], np.float32)),
            ]
        else:
            raise ValueError(f"unknown synthetic scene archetype {archetype!r}")

        # orbit trajectory
        radius = float(c["orbit_radius"])
        self.gt_c2ws = np.stack(
            [
                _look_at(
                    np.array(
                        [
                            radius * np.cos(2 * np.pi * i / self._n),
                            0.6 * np.sin(4 * np.pi * i / self._n),
                            radius * np.sin(2 * np.pi * i / self._n),
                        ],
                        np.float32,
                    ),
                    np.zeros(3, np.float32),
                    np.array([0.0, 1.0, 0.0], np.float32),
                )
                for i in range(self._n)
            ]
        )
        self._frames: Dict[int, np.ndarray] = {}

    @staticmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        return ["synthetic", "thin"]

    @property
    def num_images(self) -> int:
        return self._n

    @property
    def scene_dir_path(self) -> pathlib.Path:
        # the scene is procedural and has no files; relative SLAM result
        # paths resolve under the process's own temp directory
        return pathlib.Path(tempfile.gettempdir()) / "ngm_synthetic"

    # -- analytic rendering -----------------------------------------------------

    def _raycast(self, c2w: np.ndarray) -> np.ndarray:
        """Exact ray casting of spheres + room box. Returns (H, W, 4)."""
        cam = self.camera
        ii, jj = np.meshgrid(
            np.arange(cam.height), np.arange(cam.width), indexing="ij"
        )
        ijs = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float32)
        dirs = cam.ijs_to_directions(torch.from_numpy(ijs), "opengl").numpy()
        dirs_w = dirs @ c2w[:3, :3].T
        origin = c2w[:3, 3]

        t_best = np.full(len(dirs), np.inf, np.float32)
        color = np.zeros((len(dirs), 3), np.float32)

        for ctr, r, col in zip(self._sphere_c, self._sphere_r, self._sphere_col):
            oc = origin - ctr
            b = dirs_w @ oc
            cq = oc @ oc - r * r
            disc = b * b - cq
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            ok = hit & (t > 0.05) & (t < t_best)
            normal = (origin + dirs_w * t[:, None] - ctr) / r
            shade = 0.6 + 0.4 * np.clip(normal[:, 1], -1, 1)
            color[ok] = col[None] * shade[ok, None]
            t_best[ok] = t[ok]

        # finite AABBs (slab method; outward-facing, camera outside)
        for bmin, bmax, col in self._boxes:
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dirs_w
                t1 = (bmin[None] - origin[None]) * inv
                t2 = (bmax[None] - origin[None]) * inv
            lo = np.minimum(t1, t2)
            hi = np.maximum(t1, t2)
            tnear = lo.max(-1)
            tfar = hi.min(-1)
            ok = (tnear <= tfar) & (tnear > 0.05) & (tnear < t_best)
            # entry face axis -> flat per-face shading
            face_axis = lo.argmax(-1)
            shade = np.choose(face_axis, [0.85, 1.0, 0.7])
            color[ok] = col[None] * shade[ok, None]
            t_best[ok] = tnear[ok]

        # finite vertical cylinders (floor-to-ceiling, no visible caps)
        for ctr_xz, r, col in self._cyls:
            dx, dz = dirs_w[:, 0], dirs_w[:, 2]
            ox, oz = origin[0] - ctr_xz[0], origin[2] - ctr_xz[1]
            a = dx * dx + dz * dz
            b = dx * ox + dz * oz
            cq = ox * ox + oz * oz - r * r
            disc = b * b - a * cq
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            y = origin[1] + dirs_w[:, 1] * t
            ok = (
                (disc > 0) & (t > 0.05) & (t < t_best)
                & (np.abs(y) <= self._room_half)
            )
            nx = (origin[0] + dx * t - ctr_xz[0]) / r
            shade = 0.7 + 0.3 * np.clip(nx, -1, 1)
            color[ok] = col[None] * shade[ok, None]
            t_best[ok] = t[ok]

        # room box (inward-facing AABB walls)
        hh = self._room_half
        for axis in range(3):
            for sign in (-1.0, 1.0):
                denom = dirs_w[:, axis]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = (sign * hh - origin[axis]) / denom
                    t = np.where(np.isfinite(t), t, -1.0)
                    p = origin[None] + dirs_w * t[:, None]
                    others = [a for a in range(3) if a != axis]
                    inside = (
                        (np.abs(p[:, others[0]]) <= hh)
                        & (np.abs(p[:, others[1]]) <= hh)
                        & (t > 0.05)
                    )
                    ok = inside & (t < t_best)
                    checker = (
                        np.floor(p[:, others[0]] * 2) + np.floor(p[:, others[1]] * 2)
                    ) % 2
                wall_col = 0.35 + 0.3 * checker
                color[ok] = np.stack([wall_col, wall_col, wall_col * 0.9], -1)[ok]
                t_best[ok] = t[ok]

        depth = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)
        # distances -> z-depth (opengl z = -dirs_z * t; depth = -z_cam)
        z_depth = depth * (-dirs[:, 2])
        rgbd = np.concatenate([color, z_depth[:, None]], axis=-1)
        return rgbd.reshape(self.camera.height, self.camera.width, 4)

    def _get_sequence_item(self, index: int) -> dict:
        if index not in self._frames:
            self._frames[index] = self._raycast(self.gt_c2ws[index])
        return {
            "time": index / 30.0,
            "rgbd": self._frames[index],
            "c2w": self.gt_c2ws[index],
        }

    @property
    def has_gt_mesh(self) -> bool:
        return False
