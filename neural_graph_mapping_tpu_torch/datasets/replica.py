"""Replica dataset loader (port of neural_graph_mapping_tpu.datasets.replica;
numpy host code, frames read through ``utils/imageio``).

Directory layout (iMAP/NICE-SLAM rendering of Replica):
    {root_dir}/cam_params.json            intrinsics + depth scale
    {root_dir}/{scene}/traj.txt           N*4 x 4 OpenCV c2w matrices
    {root_dir}/{scene}/results/frame*.jpg (any ``frame*`` file; PNGs need no PIL)
    {root_dir}/{scene}/results/depth*.png (depth scale from cam_params)
    {root_dir}/{scene}_mesh.ply           GT quadmesh
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional

import numpy as np

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.base import OGL2OCV, SLAMDataset
from neural_graph_mapping_tpu_torch.utils import imageio, meshio

# per-scene CO-SLAM / NICE-SLAM bounds (reference replica_dataset.py:433-459)
_CUSTOM_BOUNDS = {
    "room0": [[-1.0, -1.3, -1.7], [7.0, 3.7, 1.4]],
    "room1": [[-5.6, -3.2, -1.6], [1.4, 2.8, 1.8]],
    "room2": [[-0.9, -3.3, -3.0], [6.0, 1.8, 0.7]],
    "office0": [[-2.2, -3.4, -1.4], [2.6, 2.1, 2.0]],
    "office1": [[-1.9, -1.6, -1.1], [3.1, 2.6, 1.8]],
    "office2": [[-3.5, -2.9, -1.3], [3.1, 5.4, 1.6]],
    "office3": [[-5.2, -6.0, -1.3], [3.6, 3.3, 1.9]],
    "office4": [[-1.3, -2.4, -1.3], [5.4, 4.3, 1.7]],
}


class ReplicaDataset(SLAMDataset):
    """Replica dataset (reference replica_dataset.py:27)."""

    default_config = dict(
        SLAMDataset.default_config,
        fps=30,
        frame_skip=0,
        scale=1.0,
    )

    def __init__(self, config: dict) -> None:
        super().__init__(config)
        c = self.config
        self._fps = float(c["fps"])
        self._skip = int(c["frame_skip"]) + 1
        self._scale = float(c["scale"])

        with open(self.root_dir_path / "cam_params.json") as f:
            cam = json.load(f)["camera"]
        self._depth_scale = float(cam["scale"])
        self.camera = Camera.create(
            cam["w"], cam["h"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
            pixel_center=0.0,
        )

        results = self.scene_dir_path / "results"
        self._image_files = sorted(results.glob("frame*"))[:: self._skip]
        self._depth_files = sorted(results.glob("depth*"))[:: self._skip]

        poses = np.loadtxt(self.scene_dir_path / "traj.txt").reshape(-1, 4, 4)
        poses = poses[:: self._skip].astype(np.float32)
        poses[:, :3, 3] *= self._scale
        self.gt_c2ws = poses @ OGL2OCV[None]  # OpenCV -> OpenGL (:216-217)

    @staticmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        root = pathlib.Path(root_dir)
        if not root.is_dir():
            return []
        return sorted(p.name for p in root.iterdir() if (p / "traj.txt").is_file())

    @property
    def num_images(self) -> int:
        return len(self._image_files)

    @property
    def scene_dir_path(self) -> pathlib.Path:
        return self.root_dir_path / self.scene

    @property
    def has_gt_mesh(self) -> bool:
        return self.gt_mesh_path.is_file()

    @property
    def gt_mesh_path(self) -> pathlib.Path:
        return self.root_dir_path / f"{self.scene}_mesh.ply"

    def load_gt_mesh(self) -> meshio.Mesh:
        # Replica GT meshes are quadmeshes; the PLY loader triangulates
        # (the reference uses trimesh for this, replica_dataset.py:153-161)
        return meshio.load_ply(self.gt_mesh_path)

    def _get_sequence_item(self, index: int) -> dict:
        rgb = np.asarray(imageio.read_image(self._image_files[index]), np.float32)[..., :3] / 255.0
        depth = (
            np.asarray(imageio.read_image(self._depth_files[index]), np.float32)
            / self._depth_scale
            * self._scale
        )
        rgbd = np.concatenate([rgb, depth[..., None]], axis=-1).astype(np.float32)
        return {
            "time": index / self._fps,
            "rgbd": rgbd,
            "c2w": self.gt_c2ws[index],
        }

    @property
    def custom_scene_bounds(self) -> Optional[np.ndarray]:
        bounds = _CUSTOM_BOUNDS.get(self.scene)
        return None if bounds is None else np.asarray(bounds, np.float32)
