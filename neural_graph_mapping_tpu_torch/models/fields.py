"""Neural fields: encoding + MLP, and posed multi-field sets (port of
neural_graph_mapping_tpu.models.fields, training path).

Fields are functional ``nn.Module``s: parameters live in flat dicts whose
tensors carry a leading field axis, ``(N_cap, ...)``, exactly the JAX
package's stacked pytree (keys ``enc.table``, ``w{i}``, ``b{i}``, optional
``rezero`` and ``neus_sd``). The modules hold only constants (as buffers).
``jax.vmap`` over fields becomes a written-out field batch dimension: the
encode kernels take all fields in one launch and the per-field MLP is a
batched matrix product.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from neural_graph_mapping_tpu_torch.config import str_to_object

Params = Dict[str, torch.Tensor]


class NeuralField(nn.Module):
    """Positional encoding followed by a small MLP.

    Skip modes: "no", "add", "concat", "rezero", as in the JAX package.
    """

    def __init__(
        self,
        encoding_type,
        encoding_kwargs: dict,
        num_layers: int,
        dim_out: int,
        dim_mlp_out: Optional[int] = None,
        skip_mode: str = "no",
        initial_geometry_bias: float = 0.0,
        neus_initial_sd: Optional[float] = None,
    ) -> None:
        super().__init__()
        if skip_mode is False:  # YAML 1.1 parses bare `no` as boolean
            skip_mode = "no"
        if skip_mode not in ("no", "add", "concat", "rezero"):
            raise ValueError(f"Skip mode {skip_mode} is not available.")
        enc_cls = str_to_object(encoding_type) if isinstance(encoding_type, str) else encoding_type
        self.encoding = enc_cls(**encoding_kwargs)
        self.dim_encoding = self.encoding.get_out_dim()
        self.num_layers = int(num_layers)
        self.dim_out = int(dim_out)
        self.dim_mlp_out = self.dim_encoding if dim_mlp_out is None else int(dim_mlp_out)
        self.skip_mode = skip_mode
        self.initial_geometry_bias = float(initial_geometry_bias)
        self.neus_initial_sd = neus_initial_sd
        if skip_mode in ("no", "add", "rezero"):
            self.dim_mlp_in = self.dim_mlp_out
        else:  # concat
            self.dim_mlp_in = self.dim_mlp_out + self.dim_encoding
        self.dims_in = [self.dim_encoding] + [self.dim_mlp_in] * self.num_layers
        self.dims_out = [self.dim_mlp_out] * self.num_layers + [self.dim_out]

    def init(self, num: int, generator: Optional[torch.Generator] = None, device=None) -> Params:
        """Stacked parameters for ``num`` independent fields. Linears follow
        torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
        params: Params = {}
        for name, value in self.encoding.init(num, generator, device).items():
            params[f"enc.{name}"] = value
        for i, (din, dout) in enumerate(zip(self.dims_in, self.dims_out)):
            bound = 1.0 / float(din) ** 0.5
            for key, shape in ((f"w{i}", (num, din, dout)), (f"b{i}", (num, dout))):
                u = torch.rand(shape, generator=generator, device=device)
                params[key] = bound * (2.0 * u - 1.0)
        last = len(self.dims_in) - 1
        params[f"b{last}"][:, -1] += self.initial_geometry_bias
        if self.skip_mode == "rezero":
            params["rezero"] = torch.zeros((num, self.num_layers), device=device)
        if self.neus_initial_sd is not None:
            params["neus_sd"] = torch.full((num,), float(self.neus_initial_sd), device=device)
        return params

    def apply_fm_soa(self, params: Params, coords) -> torch.Tensor:
        """Feature-major evaluate from SoA local coords (d tensors of (..., P))
        -> (..., dim_out, P); params may carry the same leading dims."""
        enc_params = {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith("enc.")}
        return self.mlp_fm(params, self.encoding.apply_fm_soa(enc_params, coords))

    def mlp_fm(self, params: Params, outs_encoding: torch.Tensor) -> torch.Tensor:
        """Feature-major MLP (..., dim_encoding, P) -> (..., dim_out, P).
        With a field batch dimension each layer is one ``bmm``."""
        outs = outs_encoding
        d_enc = self.dim_encoding
        for i in range(len(self.dims_in)):
            prev_outs = outs
            outs = torch.matmul(params[f"w{i}"].transpose(-1, -2), outs) + params[f"b{i}"][..., None]
            if i == self.num_layers:
                break
            outs = torch.relu(outs)
            if self.skip_mode == "concat":
                outs = torch.cat([outs, outs_encoding], dim=-2)
            elif self.skip_mode == "add":
                outs = torch.cat([outs[..., :d_enc, :] + outs_encoding, outs[..., d_enc:, :]], dim=-2)
            elif self.skip_mode == "rezero":
                rz = params["rezero"][..., i, None, None]
                if i == 0:
                    outs = torch.cat(
                        [rz * outs[..., :d_enc, :] + prev_outs, rz * outs[..., d_enc:, :]], dim=-2
                    )
                else:
                    outs = rz * outs + prev_outs
        return outs


class NeuralFieldSet(nn.Module):
    """Set of posed neural fields (training path: field-parallel evaluation
    of gathered field slices)."""

    def __init__(
        self,
        dim_points: int,
        field_type,
        field_kwargs: dict,
        num_knn: int,
        distance_factor: float,
        outside_value: float,
        field_radius: Optional[float] = None,
        scale_mode: str = "no",
    ) -> None:
        super().__init__()
        if scale_mode not in ("no", "unit_ball", "unit_cube"):
            raise NotImplementedError(f"{scale_mode=} is not available.")
        if scale_mode != "no" and field_radius is None:
            raise ValueError(f"{scale_mode=} requires field_radius to be specified.")
        if dim_points != 3:
            raise NotImplementedError("The port supports 3D fields only.")
        self.dim_points = int(dim_points)
        field_cls = str_to_object(field_type) if isinstance(field_type, str) else field_type
        self.prototype = field_cls(**field_kwargs)
        self.num_knn = int(num_knn)
        self.distance_factor = float(distance_factor)
        self.outside_value = float(outside_value)
        self.field_radius = field_radius
        self.scale_mode = scale_mode

    def init_fields(
        self, num_fields: int, generator: Optional[torch.Generator] = None, device=None
    ) -> Params:
        """Stacked parameters for ``num_fields`` fields (independent draws)."""
        return self.prototype.init(num_fields, generator, device)

    def gather_fields(self, stacked_params: Params, field_ids: torch.Tensor) -> Params:
        """Slice out a subset of fields (a gather along the field axis)."""
        return {k: v.index_select(0, field_ids) for k, v in stacked_params.items()}

    def world_to_local_soa(self, coords, field_positions, field_orientations):
        """SoA world -> field-local (+ scale) on (F, P) per-coordinate tensors:
        translate, then rotate by the inverse (conjugate) orientation."""
        px = coords[0] - field_positions[:, 0:1]
        py = coords[1] - field_positions[:, 1:2]
        pz = coords[2] - field_positions[:, 2:3]
        qw = field_orientations[:, 0:1]
        qx = -field_orientations[:, 1:2]
        qy = -field_orientations[:, 2:3]
        qz = -field_orientations[:, 3:4]
        # p' = p + qw * t + q x t, with t = 2 q x p
        tx = 2.0 * (qy * pz - qz * py)
        ty = 2.0 * (qz * px - qx * pz)
        tz = 2.0 * (qx * py - qy * px)
        ox = px + qw * tx + (qy * tz - qz * ty)
        oy = py + qw * ty + (qz * tx - qx * tz)
        oz = pz + qw * tz + (qx * ty - qy * tx)
        if self.scale_mode == "unit_cube":
            s = 1.0 / (2.0 * self.field_radius)
            return (ox * s + 0.5, oy * s + 0.5, oz * s + 0.5)
        if self.scale_mode == "unit_ball":
            s = 1.0 / self.field_radius
            return (ox * s, oy * s, oz * s)
        return (ox, oy, oz)

    def apply_vmap_fm_soa(
        self, vmap_params: Params, coords, field_positions, field_orientations
    ) -> torch.Tensor:
        """Field-parallel evaluation: world coords (3 x (F, P)) -> (F, dim_out, P)."""
        local = self.world_to_local_soa(coords, field_positions, field_orientations)
        return self.prototype.apply_fm_soa(vmap_params, local)
