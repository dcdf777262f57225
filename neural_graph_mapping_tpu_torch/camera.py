"""Pinhole camera model (port of neural_graph_mapping_tpu.camera).

The camera is a frozen dataclass of Python scalars; every method takes
tensors and returns tensors on the same device. Pixel-centre conventions are
the JAX package's: the principal point is stored at pixel_center 0.5, and
:meth:`Camera.get_pinhole_camera_parameters` converts on request.
"""

from __future__ import annotations

import dataclasses
import functools
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

    def scaled_camera(self, scale_factor: float) -> "Camera":
        """Camera with all intrinsics scaled (width and height truncated to int)."""
        return Camera(
            width=int(self.width * scale_factor),
            height=int(self.height * scale_factor),
            fx=self.fx * scale_factor,
            fy=self.fy * scale_factor,
            cx=self.cx * scale_factor,
            cy=self.cy * scale_factor,
        )

    def project_points(
        self, points: torch.Tensor, convention: str, pixel_center: float = 0.5
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project camera-frame points (..., 3) to image coordinates.

        Returns (points2d (..., 2) [x, y], in_front_mask (...)).
        """
        proj = _projection_matrix(self, convention, pixel_center, points.device)
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

    def sample_ijs_uniform(
        self,
        ijs: torch.Tensor,
        num_samples: int,
        near_distances=None,
        far_distances=None,
        weights: Optional[torch.Tensor] = None,
        boundaries: Optional[torch.Tensor] = None,
        convention: str = "opengl",
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,
        r: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample points along rays through given pixels.

        Two modes:
        - stratified-uniform in [near, far) (``weights`` / ``boundaries``
          None): one uniform draw ``u`` (..., num_samples) a stratum;
        - weighted-bin: a bin of ``boundaries`` (..., num_bins + 1) drawn
          with probabilities ``weights`` (..., num_bins) by the draw ``r``
          against the weights' cumulative sum + 1e-3 (counted, then clipped
          to the last bin), then uniform within it by the draw ``u``.

        The draws (U[0, 1), shape (..., num_samples)) are the caller's:
        passed in as ``u`` (and ``r``), or drawn from ``generator``.

        Returns:
            points: Camera-frame points, shape (..., num_samples, 3).
            distances: Euclidean distances from origin, shape (..., num_samples).
        """
        lead = tuple(ijs.shape[:-1])
        if (weights is None) != (boundaries is None):
            raise ValueError("Either both or none of weights and boundaries must be None.")
        dev = ijs.device
        shape = lead + (num_samples,)

        def draw(given):
            if given is not None:
                return given
            if generator is None:
                raise ValueError("pass the draws (u, and r for weighted bins) or a generator")
            return torch.rand(shape, generator=generator, device=dev)

        dirs = self.ijs_to_directions(ijs, convention=convention)
        if boundaries is None:
            near = torch.broadcast_to(torch.as_tensor(near_distances, dtype=torch.float32, device=dev), lead)
            far = torch.broadcast_to(torch.as_tensor(far_distances, dtype=torch.float32, device=dev), lead)
            deltas = (far - near) / num_samples
            # i * (1 / S): the left edges as jnp.linspace(0, 1, S + 1) gives them
            edges = torch.arange(num_samples, dtype=torch.float32, device=dev) * (1.0 / num_samples)
            distances = deltas[..., None] * draw(u) + edges * (far - near)[..., None] + near[..., None]
        else:
            r = draw(r)
            num_bins = weights.shape[-1]
            cum_weights = torch.cumsum(weights, dim=-1) + 1e-3
            bins = torch.sum(cum_weights[..., None, :] < r[..., :, None], dim=-1)
            bins = torch.clamp(bins, 0, num_bins - 1)
            bin_deltas = boundaries[..., 1:] - boundaries[..., :-1]
            bin_starts = torch.take_along_dim(boundaries, bins, dim=-1)
            bin_sizes = torch.take_along_dim(bin_deltas, bins, dim=-1)
            distances = bin_starts + bin_sizes * draw(u)
        points = dirs[..., None, :] * distances[..., None]
        return points, distances

    def _full_ijs(self, device=None) -> torch.Tensor:
        ii, jj = torch.meshgrid(
            torch.arange(self.height, device=device),
            torch.arange(self.width, device=device),
            indexing="ij",
        )
        return torch.stack([ii, jj], dim=-1).reshape(-1, 2)

    def distance_to_depth(
        self, distances: torch.Tensor, ijs: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Convert along-ray distances to z-depths."""
        if ijs is None:
            ijs = self._full_ijs(distances.device).reshape(self.height, self.width, 2)
        dirs = self.ijs_to_directions(ijs, convention="opencv")
        return distances * dirs[..., 2]

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


@functools.lru_cache(maxsize=None)
def _projection_matrix(camera: Camera, convention: str, pixel_center: float, device) -> torch.Tensor:
    """``camera``'s projection matrix on ``device``, made once: a copy from
    the host waits for the device, and a CUDA graph cannot record one."""
    return camera.get_projection_matrix(convention, pixel_center, device)
