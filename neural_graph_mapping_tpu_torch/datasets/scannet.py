"""ScanNet dataset loader (port of neural_graph_mapping_tpu.datasets.scannet;
numpy host code, frames read through ``utils/imageio``).

Directory layout (ScanNet sens export):
    {root_dir}/{scene}/color/*.jpg        high-res color
    {root_dir}/{scene}/depth/*.png        depth (mm), depth-camera resolution
    {root_dir}/{scene}/pose/*.txt         per-frame 4x4 OpenCV c2w
    {root_dir}/{scene}/intrinsic/intrinsic_depth.txt
Color frames are resized (Lanczos, PIL's) to the depth resolution and cached
to ``aligned_color_to_depth/`` on first use (reference
scannet_dataset.py:202-212); where that directory exists, PIL is needed only
to read JPEG frames. Intrinsics use pixel_center = 1.0 (reference :200).
"""

from __future__ import annotations

import pathlib
import re
from typing import List

import numpy as np

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.base import OGL2OCV, SLAMDataset
from neural_graph_mapping_tpu_torch.utils import imageio, meshio


def _last_int(path) -> int:
    return int(re.findall(r"\d+", pathlib.Path(path).name)[-1])


class ScanNetDataset(SLAMDataset):
    """ScanNet dataset (reference scannet_dataset.py:31)."""

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

        self._color_dir = self.scene_dir_path / "aligned_color_to_depth"
        self._depth_dir = self.scene_dir_path / "depth"
        if not self._color_dir.exists():
            self._preprocess_color()
        self._image_files = sorted(self._color_dir.iterdir(), key=_last_int)[:: self._skip]
        self._depth_files = sorted(self._depth_dir.iterdir(), key=_last_int)[:: self._skip]

        intr = np.loadtxt(self.scene_dir_path / "intrinsic" / "intrinsic_depth.txt")
        w, h = self._depth_image_size()
        self.camera = Camera.create(
            w, h, intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2], pixel_center=1.0
        )

        poses = []
        for i in range(0, len(list(self._depth_dir.iterdir()))):
            pose_path = self.scene_dir_path / "pose" / f"{i}.txt"
            if pose_path.is_file():
                c2w = np.loadtxt(pose_path).astype(np.float32)
                c2w[:3, 3] *= self._scale
            else:
                c2w = np.full((4, 4), np.nan, np.float32)
            poses.append(c2w)
        poses = np.stack(poses)[:: self._skip]
        self.gt_c2ws = poses @ OGL2OCV[None]  # OpenCV -> OpenGL

    def _depth_image_size(self):
        return imageio.image_size(sorted(self._depth_dir.iterdir(), key=_last_int)[0])  # (w, h)

    def _preprocess_color(self) -> None:
        """Resize color to the depth resolution, cached to disk
        (reference scannet_dataset.py:202-212)."""
        import PIL.Image

        self._color_dir.mkdir(parents=True)
        size = self._depth_image_size()
        raw_dir = self.scene_dir_path / "color"
        for raw_path in sorted(raw_dir.iterdir()):
            img = PIL.Image.open(raw_path)
            img.resize(size, resample=PIL.Image.Resampling.LANCZOS).save(
                self._color_dir / raw_path.name
            )

    @staticmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        root = pathlib.Path(root_dir)
        if not root.is_dir():
            return []
        return sorted(
            p.name
            for p in root.iterdir()
            if (p / "color").exists()
            and (p / "depth").exists()
            and (p / "pose").exists()
            and (p / "intrinsic").exists()
        )

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
        return self.scene_dir_path / f"{self.scene}_vh_clean.ply"

    def load_gt_mesh(self) -> meshio.Mesh:
        return meshio.load_ply(self.gt_mesh_path)

    def _get_sequence_item(self, index: int) -> dict:
        rgb = np.asarray(imageio.read_image(self._image_files[index]), np.float32)[..., :3] / 255.0
        depth = (
            np.asarray(imageio.read_image(self._depth_files[index]), np.float32)
            * 0.001
            * self._scale
        )
        rgbd = np.concatenate([rgb, depth[..., None]], axis=-1).astype(np.float32)
        return {
            "time": index / self._fps,
            "rgbd": rgbd,
            "c2w": self.gt_c2ws[index],
        }
