"""Neural RGB-D dataset loader (port of
neural_graph_mapping_tpu.datasets.nrgbd; numpy host code, frames read
through ``utils/imageio``).

Directory layout (dazinovic/neural-rgbd-surface-reconstruction):
    {root_dir}/{scene}/images/            img*.png color frames
    {root_dir}/{scene}/depth_filtered/    depth*.png (mm)
    {root_dir}/{scene}/poses.txt          N*4 x 4 OpenGL c2w matrices
    {root_dir}/{scene}/gt_mesh.ply
plus the precomputed ORB-SLAM2 result files named in the config.
"""

from __future__ import annotations

import os
import pathlib
import re
from typing import List, Optional

import numpy as np

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.base import SLAMDataset
from neural_graph_mapping_tpu_torch.utils import imageio, meshio

# per-scene CO-SLAM scene bounds (reference nrgbd_dataset.py:409-433)
_CUSTOM_BOUNDS = {
    "breakfast_room": [[-2.4, -0.6, -1.8], [2.0, 2.9, 3.1]],
    "complete_kitchen": [[-5.7, -0.2, -6.6], [3.8, 3.3, 3.6]],
    "green_room": [[-2.6, -0.3, 0.2], [5.6, 3.0, 5.1]],
    "grey_white_room": [[-0.7, -0.2, -3.9], [5.4, 3.1, 0.8]],
    "morning_apartment": [[-1.5, -0.3, -2.3], [2.2, 2.2, 1.9]],
    "thin_geometry": [[-2.5, -0.3, 0.1], [1.1, 1.1, 3.9]],
    "whiteroom": [[-2.6, -0.1, 0.5], [3.2, 3.6, 8.3]],
}


def _last_int(name: str) -> int:
    return int(re.findall(r"\d+", name)[-1])


class NRGBDDataset(SLAMDataset):
    """Neural RGB-D dataset (reference nrgbd_dataset.py:17)."""

    default_config = dict(
        SLAMDataset.default_config,
        images_dir="images",
        image_dir=None,  # legacy alias for images_dir
        depth_dir="depth_filtered",
        poses_file="poses.txt",
        fps=30,
        frame_skip=0,
        scale=1.0,
        camera=None,  # kwargs for Camera.create
    )

    def __init__(self, config: dict) -> None:
        super().__init__(config)
        c = self.config
        self._fps = float(c["fps"])
        self._skip = int(c["frame_skip"]) + 1
        self._scale = float(c["scale"])
        self._depth_dir_name = c["depth_dir"]
        self.camera = Camera.create(**c["camera"])

        images_dir = c.get("image_dir") or c["images_dir"]  # ref key: images_dir
        self._image_dir = self.scene_dir_path / images_dir
        self._depth_dir = self.scene_dir_path / c["depth_dir"]
        self._image_files = sorted(os.listdir(self._image_dir), key=_last_int)[:: self._skip]
        self._depth_files = sorted(os.listdir(self._depth_dir), key=_last_int)[:: self._skip]

        poses = np.loadtxt(self.scene_dir_path / c["poses_file"]).reshape(-1, 4, 4)
        poses = poses[:: self._skip].astype(np.float32)
        poses[:, :3, 3] *= self._scale
        self.gt_c2ws = poses  # already OpenGL convention

    @staticmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        root = pathlib.Path(root_dir)
        return sorted(
            p.name for p in root.iterdir() if (p / "gt_mesh.ply").is_file()
        ) if root.is_dir() else []

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
        return self.scene_dir_path / "gt_mesh.ply"

    def load_gt_mesh(self) -> meshio.Mesh:
        return meshio.load_ply(self.gt_mesh_path)

    def _load_depth(self, path) -> np.ndarray:
        depth = np.asarray(imageio.read_image(path), np.float32) * 0.001 * self._scale
        if self._depth_dir_name == "depth_filtered":
            # de-bias fit for the filtered depth (nrgbd_dataset.py:371-375)
            depth = 0.00123631 * depth**2 + (1 + 0.00073707) * depth
        return depth

    def _get_sequence_item(self, index: int) -> dict:
        rgb = np.asarray(
            imageio.read_image(self._image_dir / self._image_files[index]), np.float32
        )[..., :3] / 255.0
        depth = self._load_depth(self._depth_dir / self._depth_files[index])
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
