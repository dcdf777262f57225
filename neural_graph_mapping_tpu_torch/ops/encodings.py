"""Permutohedral hash encoding as an ``nn.Module`` (port of
neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding).

The module holds no parameters: hash tables live in the stacked per-field
parameter dict (key ``enc.table``, shape (N, F, L, T), feature-major), as in
the JAX package. The lattice constants are buffers, plus the same values as
Python tuples for the kernels' launch constants. Scales, shifts and per-level
capacities are computed exactly as the JAX package computes them, so a table
means the same thing in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from neural_graph_mapping_tpu_torch.ops import permuto

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
        out = permuto.encode_fused(
            params["table"], stacked, self._scales_t, self._shifts_t, self._elev_t,
            self.level_capacities,
        )
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
