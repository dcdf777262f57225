"""Positional encodings as ``nn.Module``s (port of
neural_graph_mapping_tpu.ops.encodings).

The modules hold no parameters: those live in the stacked per-field
parameter dict, with a leading field axis, as in the JAX package:
``enc.table`` (N, F, L, T) feature-major for the permutohedral encoding,
``enc.planes`` (N, 3, C, R, R) for the triplane, ``enc.fourier_w``
(N, dim_in, n) for random Fourier features, none for the NeRF octaves.
``init(num, generator, device)`` draws ``num`` fields' parameters from an
explicit generator; ``apply(params, points)`` takes params with leading
field dims (B...) and points (B..., ..., dim_in).

The permutohedral lattice constants are buffers, plus the same values as
Python tuples for the kernels' launch constants. Scales, shifts and
per-level capacities are computed exactly as the JAX package computes them,
so a table means the same thing in both packages. Only the permutohedral
encoding has the feature-major ``apply_fm_soa`` that training takes; the
other three give ``apply`` only, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from neural_graph_mapping_tpu_torch.ops import permuto, permuto_cuda

Params = Dict[str, torch.Tensor]


class PermutohedralEncoding(nn.Module):
    """Multiresolution permutohedral-lattice hash encoding."""

    def __init__(
        self,
        pos_dim: int,
        log2_hashmap_size: int,
        nr_levels: int,
        nr_feat_per_level: int,
        coarsest_scale: float,
        finest_scale: float,
        appply_random_shift_per_level: bool = True,  # (sic) reference arg name
        concat_points: bool = False,
        concat_points_scaling: float = 1.0,
        init_scale: float = 1e-5,
        shift_seed: int = 0,
        per_level_capacities: bool = True,
    ) -> None:
        super().__init__()
        self.pos_dim = int(pos_dim)
        self.capacity = int(2**log2_hashmap_size)
        self.nr_levels = int(nr_levels)
        self.nr_feat_per_level = int(nr_feat_per_level)
        self.init_scale = float(init_scale)
        self.concat_points = bool(concat_points)
        self.concat_points_scaling = float(concat_points_scaling)
        d = self.pos_dim
        scales = np.geomspace(coarsest_scale, finest_scale, num=nr_levels).astype(np.float32)
        if appply_random_shift_per_level:
            rng = np.random.RandomState(shift_seed)
            shifts = rng.uniform(0.0, 10.0, size=(nr_levels, d)).astype(np.float32)
        else:
            shifts = np.zeros((nr_levels, d), dtype=np.float32)
        elev = permuto.make_elevation_scale(d)
        self.register_buffer("scales", torch.from_numpy(scales))
        self.register_buffer("shifts", torch.from_numpy(shifts))
        self.register_buffer("elev_scale", torch.from_numpy(elev))
        self._scales_t = tuple(float(s) for s in scales)
        self._shifts_t = tuple(tuple(float(x) for x in row) for row in shifts)
        self._elev_t = tuple(float(e) for e in elev)
        # Per-level table sizes: coarse levels touch few lattice cells, so
        # their hash range is a power of two with 2x headroom over the probed
        # cell count; once a level is hashed, all finer ones are too.
        if self.pos_dim == 3 and per_level_capacities:
            caps = []
            hashed = False
            for l, scale in enumerate(self._scales_t):
                if hashed:
                    caps.append(self.capacity)
                    continue
                n_cells = permuto.count_lattice_cells(scale, shifts[l], elev)
                cap = 128
                while cap < 2 * n_cells:
                    cap *= 2
                if cap >= self.capacity:
                    cap = self.capacity
                    hashed = True
                caps.append(cap)
            self.level_capacities = tuple(caps)
        else:
            self.level_capacities = (self.capacity,) * self.nr_levels
        self.register_buffer(
            "level_capacity", torch.tensor(self.level_capacities, dtype=torch.int64)
        )

    def get_out_dim(self) -> int:
        out = self.nr_levels * self.nr_feat_per_level
        if self.concat_points:
            out += self.pos_dim
        return out

    def init(
        self, num: int, generator: Optional[torch.Generator] = None, device=None
    ) -> Params:
        """Stacked tables for ``num`` fields: (num, F, L, T) ~ U(-s, s)."""
        shape = (num, self.nr_feat_per_level, self.nr_levels, self.capacity)
        u = torch.rand(shape, generator=generator, device=device)
        return {"table": self.init_scale * (2.0 * u - 1.0)}

    def _uses_fused(self) -> bool:
        return self.pos_dim == 3 and self.nr_feat_per_level == 2

    @property
    def graphable(self) -> bool:
        """Whether the encode is the fused kernel pair alone (no points
        concatenated), so that a caller may run its forward and its table
        gradient as :meth:`fused_forward` and :meth:`fused_table_grad`."""
        return self._uses_fused() and not self.concat_points

    def _consts(self) -> tuple:
        return self._scales_t, self._shifts_t, self._elev_t, self.level_capacities

    def fused_forward(self, table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """The ``encode_fwd`` kernel outside autograd: table (..., 2, L, T),
        stacked coords (..., 3, P) -> (..., 2L, P)."""
        return permuto_cuda.encode_fwd(table, coords, *self._consts())

    def fused_table_grad(self, coords: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """The ``encode_bwd_table`` kernel: d loss / d table from the
        gradient of :meth:`fused_forward`'s output."""
        return permuto_cuda.encode_bwd_table(coords, grad.contiguous(), *self._consts())

    def apply_fm_soa(self, params: Params, coords) -> torch.Tensor:
        """Feature-major encode from SoA coords (d tensors of (..., P))
        -> (..., out_dim, P); ``params["table"]`` is (..., F, L, T).

        3D with 2 features per level (the production shape) runs the fused
        encode kernels, whose coordinate gradient is zero; other shapes take
        the gather route (:meth:`gather_fm_soa`).
        """
        if not self._uses_fused():
            return self.gather_fm_soa(params, coords)
        stacked = torch.stack(coords, dim=-2).contiguous()  # (..., 3, P)
        out = permuto.encode_fused(params["table"], stacked, *self._consts())
        return self._concat_points(out, coords)

    def gather_fm_soa(self, params: Params, coords) -> torch.Tensor:
        """The gather route, for every shape: the plain lattice, then
        :func:`permuto.gather_blend` (the ``gather_pairs`` / ``table_grad``
        kernels on the card). Differentiable in the points."""
        idx, w = permuto.lattice_keys_and_weights_soa(
            coords, self.scales, self.shifts, self.elev_scale, self.level_capacities
        )
        return self._concat_points(permuto.gather_blend(params["table"], idx, w), coords)

    def _concat_points(self, out: torch.Tensor, coords) -> torch.Tensor:
        if not self.concat_points:
            return out
        return torch.cat(
            [out] + [self.concat_points_scaling * c[..., None, :] for c in coords], dim=-2
        )

    def apply_fm(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """Feature-major encode: points (..., P, d) -> (..., out_dim, P)."""
        return self.apply_fm_soa(params, points.unbind(-1))

    def apply(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """Channels-last encode on the gather route, differentiable in the
        points: points (..., d) -> (..., out_dim). A table with leading
        field dims (B..., F, L, T) takes points (B..., ..., d).

        The JAX package's ``apply`` goes through ``apply_fm_soa``, which on
        a TPU takes the fused kernels and drops the point gradient; this
        always takes the gather route, the JAX CPU semantics.
        """
        n_lead = params["table"].ndim - 3
        lead = points.shape[:-1]
        flat = points.reshape(lead[:n_lead] + (-1, self.pos_dim))
        out = self.gather_fm_soa(params, flat.unbind(-1))  # (B..., out_dim, M)
        return out.transpose(-1, -2).reshape(lead + (self.get_out_dim(),))


def _flatten_points(points: torch.Tensor, n_lead: int, dim: int) -> torch.Tensor:
    """points (B..., ..., dim) -> (B..., M, dim) for ``n_lead`` field dims."""
    return points.reshape(points.shape[:n_lead] + (-1, dim))


class TriplaneEncoding(nn.Module):
    """Learned triplane encoding: three axis-aligned feature planes sampled
    bilinearly (align-corners, border) at the point's projections onto the
    xy, xz and yz planes, combined by sum, product or concatenation.
    Expects inputs in [-1, 1]."""

    def __init__(
        self,
        resolution: int = 32,
        num_components: int = 64,
        init_scale: float = 0.1,
        mode: str = "sum",
    ) -> None:
        super().__init__()
        if mode not in ("sum", "product", "concat"):
            raise ValueError(f"{mode=} is not supported.")
        self.resolution = int(resolution)
        self.num_components = int(num_components)
        self.init_scale = float(init_scale)
        self.mode = mode

    def get_out_dim(self) -> int:
        if self.mode == "concat":
            return 3 * self.num_components
        return self.num_components

    def init(self, num: int, generator: Optional[torch.Generator] = None, device=None) -> Params:
        """(num, 3, C, R, R) planes ~ init_scale * N(0, 1)."""
        shape = (num, 3, self.num_components, self.resolution, self.resolution)
        return {"planes": self.init_scale * torch.randn(shape, generator=generator, device=device)}

    @staticmethod
    def _grid_sample_bilinear(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """plane (B..., C, R, R), coords (B..., M, 2) in [-1, 1] -> (B..., C, M).

        The JAX package's formula term for term: coords[..., 0] indexes the
        width (last) axis, the cell's corner is clipped to R - 2 so the last
        row and column interpolate from the cell before them."""
        c, h, w = plane.shape[-3:]
        x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
        y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
        x = torch.clamp(x, 0.0, w - 1)
        y = torch.clamp(y, 0.0, h - 1)
        x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
        y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
        tx = (x - x0)[..., None, :]
        ty = (y - y0)[..., None, :]
        flat = plane.reshape(plane.shape[:-2] + (h * w,))

        def tap(yy, xx):
            idx = (yy * w + xx)[..., None, :]
            return torch.gather(flat, -1, idx.expand(idx.shape[:-2] + (c, idx.shape[-1])))

        top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
        bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
        return top * (1 - ty) + bot * ty

    def apply(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """points (B..., ..., 3) -> (B..., ..., out_dim)."""
        planes = params["planes"]
        n_lead = planes.ndim - 4
        pts = _flatten_points(points, n_lead, 3)
        feats = [
            self._grid_sample_bilinear(planes[..., i, :, :, :], pts[..., axes])
            for i, axes in enumerate(((0, 1), (0, 2), (1, 2)))
        ]  # 3 x (B..., C, M)
        if self.mode == "sum":
            out = feats[0] + feats[1] + feats[2]
        elif self.mode == "product":
            out = feats[0] * feats[1] * feats[2]
        else:
            out = torch.cat(feats, dim=-2)
        return out.transpose(-1, -2).reshape(points.shape[:-1] + (self.get_out_dim(),))


class PositionalEncodingFourier(nn.Module):
    """Random Fourier features sin(x W), optionally after the raw coordinates."""

    def __init__(self, dim_in: int, dim_out: int, mu: float, sigma: float, raw_coords: bool) -> None:
        super().__init__()
        self.dim_in = int(dim_in)
        self.dim_out = int(dim_out)
        self.mu = float(mu)
        self.sigma = float(sigma)
        self.raw_coords = bool(raw_coords)
        self._n_features = self.dim_out - self.dim_in if raw_coords else self.dim_out

    def get_out_dim(self) -> int:
        return self.dim_out

    def init(self, num: int, generator: Optional[torch.Generator] = None, device=None) -> Params:
        """(num, dim_in, n) weights ~ mu + sigma * N(0, 1)."""
        shape = (num, self.dim_in, self._n_features)
        return {"fourier_w": self.mu + self.sigma * torch.randn(shape, generator=generator, device=device)}

    def apply(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """points (B..., ..., dim_in) -> (B..., ..., dim_out)."""
        w = params["fourier_w"]
        n_lead = w.ndim - 2
        pts = _flatten_points(points, n_lead, self.dim_in)
        feats = torch.sin(torch.matmul(pts, w))
        if self.raw_coords:
            feats = torch.cat([pts, feats], dim=-1)
        return feats.reshape(points.shape[:-1] + (self.dim_out,))


class PositionalEncodingNeRF(nn.Module):
    """Sin / cos octave encoding: sin and cos of x * 2^o * pi for
    ``num_octaves`` octaves from ``start_octave``. No parameters."""

    def __init__(self, dim_in: int, num_octaves: int = 8, start_octave: int = 0) -> None:
        super().__init__()
        self.dim_in = int(dim_in)
        self.num_octaves = int(num_octaves)
        self.start_octave = int(start_octave)

    def get_out_dim(self) -> int:
        return self.dim_in * self.num_octaves * 2

    def init(self, num: int, generator: Optional[torch.Generator] = None, device=None) -> Params:
        return {}

    def apply(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """points (..., dim_in) -> (..., out_dim): all sines, then all cosines."""
        octaves = torch.arange(
            self.start_octave, self.start_octave + self.num_octaves, dtype=points.dtype,
            device=points.device,
        )
        mult = (2.0**octaves) * math.pi
        scaled = points[..., None] * mult  # (..., dim_in, num_octaves)
        lead = points.shape[:-1]
        sines = torch.sin(scaled).reshape(lead + (-1,))
        cosines = torch.cos(scaled).reshape(lead + (-1,))
        return torch.cat([sines, cosines], dim=-1)
