"""Pinhole camera model (port of neural_graph_mapping_tpu.camera).

The camera is a frozen dataclass of Python scalars; every method takes
tensors and returns tensors on the same device. Pixel-centre conventions are
the JAX package's: the principal point is stored at pixel_center 0.5, and
:meth:`Camera.get_pinhole_camera_parameters` converts on request.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics; cx, cy stored at pixel_center 0.5."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    s: float = 0.0

    @staticmethod
    def create(
        width: int,
        height: int,
        fx: float,
        fy: float,
        cx: float,
        cy: float,
        s: float = 0.0,
        pixel_center: float = 0.0,
    ) -> "Camera":
        """Build a camera from intrinsics given in any pixel-center convention."""
        if s != 0.0:
            raise NotImplementedError("Skew != 0 not supported.")
        return Camera(
            width=int(width),
            height=int(height),
            fx=float(fx),
            fy=float(fy),
            cx=float(cx) - pixel_center + 0.5,
            cy=float(cy) - pixel_center + 0.5,
            s=float(s),
        )

    def get_pinhole_camera_parameters(self, pixel_center: float) -> Tuple:
        """Return (fx, fy, cx, cy, s) in the requested pixel-center convention."""
        return (
            self.fx,
            self.fy,
            self.cx - 0.5 + pixel_center,
            self.cy - 0.5 + pixel_center,
            self.s,
        )

    def get_projection_matrix(
        self, convention: str = "opencv", pixel_center: float = 0.5, device=None
    ) -> torch.Tensor:
        """3x3 projection matrix."""
        fx, fy, cx, cy, _ = self.get_pinhole_camera_parameters(pixel_center)
        if convention == "opencv":
            rows = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
        elif convention == "opengl":
            rows = [[fx, 0.0, -cx], [0.0, -fy, -cy], [0.0, 0.0, -1.0]]
        else:
            raise ValueError(f"Unsupported camera convention {convention}.")
        return torch.tensor(rows, dtype=torch.float32, device=device)

    def project_points(
        self, points: torch.Tensor, convention: str, pixel_center: float = 0.5
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project camera-frame points (..., 3) to image coordinates.

        Returns (points2d (..., 2) [x, y], in_front_mask (...)).
        """
        proj = self.get_projection_matrix(convention, pixel_center, points.device)
        homo = torch.einsum("oi,...i->...o", proj, points)
        z = homo[..., 2]
        return homo[..., :2] / z[..., None], z > 0.0

    def ijs_to_directions(self, ijs: torch.Tensor, convention: str = "opengl") -> torch.Tensor:
        """Convert (row, column) indices to unit ray directions."""
        fx, fy, cx, cy, _ = self.get_pinhole_camera_parameters(0.0)
        d_x = (ijs[..., 1] - cx) / fx
        d_y = (ijs[..., 0] - cy) / fy
        if convention == "opengl":
            d_y = -d_y
            d_z = -torch.ones_like(d_x)
        elif convention == "opencv":
            d_z = torch.ones_like(d_x)
        else:
            raise ValueError(f"Unsupported camera convention {convention}.")
        dirs = torch.stack([d_x, d_y, d_z], dim=-1)
        return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)

    def _full_ijs(self, device=None) -> torch.Tensor:
        ii, jj = torch.meshgrid(
            torch.arange(self.height, device=device),
            torch.arange(self.width, device=device),
            indexing="ij",
        )
        return torch.stack([ii, jj], dim=-1).reshape(-1, 2)

    def depth_to_distance(
        self, depths: torch.Tensor, ijs: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Convert z-depths to along-ray distances."""
        if ijs is None:
            ijs = self._full_ijs(depths.device).reshape(self.height, self.width, 2)
        dirs = self.ijs_to_directions(ijs, convention="opencv")
        return depths / dirs[..., 2]

    def depth_to_points_full(
        self, depth_image: torch.Tensor, convention: str = "opengl"
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Back-project every pixel (static shape).

        Returns points (H*W, 3), ijs (H*W, 2) and valid (H*W,) = depth != 0.
        """
        fx, fy, cx, cy, _ = self.get_pinhole_camera_parameters(0.0)
        ijs = self._full_ijs(depth_image.device)
        depth = depth_image.reshape(-1)
        xs = (ijs[:, 1].to(depth.dtype) - cx) * depth / fx
        ys = (ijs[:, 0].to(depth.dtype) - cy) * depth / fy
        if convention == "opengl":
            points = torch.stack([xs, -ys, -depth], dim=-1)
        elif convention == "opencv":
            points = torch.stack([xs, ys, depth], dim=-1)
        else:
            raise ValueError(f"Unsupported camera convention {convention}.")
        return points, ijs, depth != 0.0
