"""Kintinuous .klg-export loader (port of
neural_graph_mapping_tpu.datasets.kintinuous; numpy host code, frames read
through ``utils/imageio``).

Directory layout (klg2png export of e.g. the NUIM loop.klg):
    {root_dir}/{scene}/color/*.png
    {root_dir}/{scene}/depth/*.png   (mm)
The dataset has no ground-truth poses: all gt c2ws are identity
(reference kintinuous_dataset.py:25); mapping runs purely from the SLAM
result files. Camera intrinsics come from the config.
"""

from __future__ import annotations

import os
import pathlib
import re
from typing import List

import numpy as np

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.base import SLAMDataset
from neural_graph_mapping_tpu_torch.utils import imageio


def _sort_key(name: str) -> float:
    nums = re.findall(r"[\d.]+", name)
    return float(nums[-1]) if nums else 0.0


class KintinuousDataset(SLAMDataset):
    """Kintinuous dataset (reference kintinuous_dataset.py:15)."""

    default_config = dict(
        SLAMDataset.default_config,
        fps=30,
        frame_skip=0,
        scale=1.0,
        camera=None,  # kwargs for Camera.create (required)
    )

    def __init__(self, config: dict) -> None:
        super().__init__(config)
        c = self.config
        self._fps = float(c["fps"])
        self._skip = int(c["frame_skip"]) + 1
        self._scale = float(c["scale"])
        self.camera = Camera.create(**c["camera"])

        self._image_dir = self.scene_dir_path / "color"
        self._depth_dir = self.scene_dir_path / "depth"
        self._image_files = sorted(os.listdir(self._image_dir), key=_sort_key)[:: self._skip]
        self._depth_files = sorted(os.listdir(self._depth_dir), key=_sort_key)[:: self._skip]

        # no ground truth: identity poses (kintinuous_dataset.py:25)
        self.gt_c2ws = np.tile(np.eye(4, dtype=np.float32), (len(self._image_files), 1, 1))

    @staticmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        root = pathlib.Path(root_dir)
        if not root.is_dir():
            return []
        return sorted(
            p.name
            for p in root.iterdir()
            if (p / "color").is_dir() and (p / "depth").is_dir()
        )

    @property
    def num_images(self) -> int:
        return len(self._image_files)

    @property
    def scene_dir_path(self) -> pathlib.Path:
        return self.root_dir_path / self.scene

    @property
    def has_gt_mesh(self) -> bool:
        return False

    def _get_sequence_item(self, index: int) -> dict:
        rgb = np.asarray(
            imageio.read_image(self._image_dir / self._image_files[index]), np.float32
        )[..., :3] / 255.0
        depth = (
            np.asarray(imageio.read_image(self._depth_dir / self._depth_files[index]), np.float32)
            * 0.001
            * self._scale
        )
        rgbd = np.concatenate([rgb, depth[..., None]], axis=-1).astype(np.float32)
        return {
            "time": index / self._fps,
            "rgbd": rgbd,
            "c2w": self.gt_c2ws[index],
        }

    @property
    def scene_bounds(self):
        return None  # no ground truth trajectory
