"""Neural fields: encoding + MLP, and posed multi-field sets (port of
neural_graph_mapping_tpu.models.fields: the training path, its fused
encode + MLP route, the point-differentiable ``apply`` / geometry gradients,
2D and 3D field sets, and the two KNN inference paths: the tiled route of
rendering and meshing, and the capacity-buffer route ``apply_knn``).

Fields are functional ``nn.Module``s: parameters live in flat dicts whose
tensors carry a leading field axis, ``(N_cap, ...)``, exactly the JAX
package's stacked pytree (keys ``enc.*`` of the encoding, ``w{i}``,
``b{i}``, optional ``rezero`` and ``neus_sd``). The modules hold only
constants (as buffers).
``jax.vmap`` over fields becomes a written-out field batch dimension: the
encode kernels take all fields in one launch and the per-field MLP is a
batched matrix product.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from neural_graph_mapping_tpu_torch.config import str_to_object
from neural_graph_mapping_tpu_torch.ops import dispatch, permuto, permuto_cuda, topk
from neural_graph_mapping_tpu_torch.utils import profiling, transforms

Params = Dict[str, torch.Tensor]


class NeuralField(nn.Module):
    """Positional encoding followed by a small MLP.

    Skip modes: "no", "add", "concat", "rezero", as in the JAX package.

    ``fused_mlp`` trains through the fused encode + MLP kernel pair
    (:func:`permuto.encode_mlp_fused`); the JAX package's ``NGM_FUSED_MLP``.
    Unlike JAX, which falls back silently, a field the kernels cannot take
    (:meth:`_supports_fused_mlp`) raises ``ValueError``.
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
        fused_mlp: bool = False,
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
        self.fused_mlp = bool(fused_mlp)
        if self.fused_mlp and not self._supports_fused_mlp():
            raise ValueError(
                "fused_mlp needs a 3D permutohedral encoding with 2 features a level and no "
                "concatenated points, one hidden layer, skip_mode 'no', and at most "
                f"{permuto_cuda.MLP_MAX_LEVELS} levels, {permuto_cuda.MLP_MAX_HIDDEN} hidden "
                f"units and {permuto_cuda.MLP_MAX_OUT} outputs"
            )

    def _supports_fused_mlp(self) -> bool:
        """The shape the fused encode + MLP kernels take (fields.py's JAX
        check, plus the kernels' compile-time widths)."""
        from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

        enc = self.encoding
        return (
            isinstance(enc, PermutohedralEncoding)
            and enc.pos_dim == 3
            and enc.nr_feat_per_level == 2
            and not enc.concat_points
            and self.num_layers == 1
            and self.skip_mode == "no"
            and enc.nr_levels <= permuto_cuda.MLP_MAX_LEVELS
            and self.dim_mlp_out <= permuto_cuda.MLP_MAX_HIDDEN
            and self.dim_out <= permuto_cuda.MLP_MAX_OUT
        )

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

    def numel(self) -> int:
        """Parameter count of one field."""
        params = self.init(1, torch.Generator().manual_seed(0), "cpu")
        return int(sum(v[0].numel() for v in params.values()))

    @staticmethod
    def _enc_params(params: Params) -> Params:
        return {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith("enc.")}

    def apply_fm(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """Feature-major evaluate: local points (..., P, pos_dim) -> (..., dim_out, P)."""
        return self.apply_fm_soa(params, points.unbind(-1))

    def apply_fm_soa(self, params: Params, coords) -> torch.Tensor:
        """Feature-major evaluate from SoA local coords (d tensors of (..., P))
        -> (..., dim_out, P); params may carry the same leading dims. With
        ``fused_mlp`` the encode and the MLP are one kernel each way.

        The training path: only the permutohedral encoding has it. A field
        with another encoding evaluates, renders and meshes through
        :meth:`apply`, and raises ``ValueError`` here (the JAX package fails
        at the same point)."""
        if not hasattr(self.encoding, "apply_fm_soa"):
            raise ValueError(
                f"{type(self.encoding).__name__} gives apply only: a field with it cannot train "
                "(training needs the feature-major apply_fm_soa of the permutohedral encoding); "
                "it can still be evaluated, rendered and meshed"
            )
        if self.fused_mlp:
            enc = self.encoding
            stacked = torch.stack(coords, dim=-2).contiguous()  # (..., 3, P)
            return permuto.encode_mlp_fused(
                params["enc.table"], params["w0"], params["b0"], params["w1"], params["b1"],
                stacked, enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities,
            )
        return self.mlp_fm(params, self.encoding.apply_fm_soa(self._enc_params(params), coords))

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

    def apply(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """Evaluate at local-frame points (..., pos_dim) -> (..., dim_out),
        through the encoding's point-differentiable gather route. Params
        with leading field dims (B...) take points (B..., ..., pos_dim)."""
        outs_encoding = outs = self.encoding.apply(self._enc_params(params), points)
        n_lead = params["w0"].ndim - 2
        shape = outs.shape
        # (B..., M, channels): one batched product a layer
        outs_encoding = outs = outs.reshape(shape[:n_lead] + (-1, shape[-1]))
        d_enc = self.dim_encoding
        for i in range(len(self.dims_in)):
            prev_outs = outs
            outs = torch.matmul(outs, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(-2)
            if i == self.num_layers:
                break
            outs = torch.relu(outs)
            if self.skip_mode == "concat":
                outs = torch.cat([outs, outs_encoding], dim=-1)
            elif self.skip_mode == "add":
                outs = torch.cat([outs[..., :d_enc] + outs_encoding, outs[..., d_enc:]], dim=-1)
            elif self.skip_mode == "rezero":
                rz = params["rezero"][..., i, None, None]
                if i == 0:
                    outs = torch.cat([rz * outs[..., :d_enc] + prev_outs, rz * outs[..., d_enc:]], dim=-1)
                else:
                    outs = rz * outs + prev_outs
        return outs.reshape(shape[:-1] + (self.dim_out,))

    def geometry_gradients(self, params: Params, points: torch.Tensor) -> torch.Tensor:
        """Spatial gradient of the geometry channel (output ``dim_out - 1``)
        w.r.t. local points (..., pos_dim) -> (..., pos_dim), by autograd
        through :meth:`apply` (the gather route, whose point gradient is
        real). Feed it to ``ops.losses.eikonal_term``. Each output depends on
        its own point only, so the gradient of the summed outputs is every
        point's own gradient."""
        pts = points.detach().requires_grad_(True)
        with torch.enable_grad():
            geometry = self.apply(params, pts)[..., -1]
            (grads,) = torch.autograd.grad(geometry.sum(), pts)
        return grads


class NeuralFieldSet(nn.Module):
    """Set of posed neural fields: field-parallel evaluation of gathered
    field slices (training) and KNN-blended evaluation through the
    tile-sorted MoE dispatch (rendering)."""

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
        if dim_points not in (2, 3):
            raise NotImplementedError("Only 2D and 3D spaces are supported.")
        self.dim_points = int(dim_points)
        if dim_points == 2:  # orientations are real-first complex rotations
            self._orientation_apply = transforms.complex_apply
            self._orientation_invert = transforms.complex_invert
        else:  # wxyz quaternions
            self._orientation_apply = transforms.quaternion_apply
            self._orientation_invert = transforms.quaternion_invert
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

    @staticmethod
    def num_fields(stacked_params: Params) -> int:
        return next(iter(stacked_params.values())).shape[0]

    def numel_per_field(self) -> int:
        """Parameter count of one field."""
        return self.prototype.numel()

    def gather_fields(self, stacked_params: Params, field_ids: torch.Tensor) -> Params:
        """Slice out a subset of fields (a gather along the field axis)."""
        return {k: v.index_select(0, field_ids) for k, v in stacked_params.items()}

    def scatter_fields(self, stacked_params: Params, field_ids: torch.Tensor, sub_params: Params) -> Params:
        """Write field slices back (a scatter along the field axis) -> new dict."""
        return {k: v.index_copy(0, field_ids, sub_params[k]) for k, v in stacked_params.items()}

    def _scale_local_points(self, local_points: torch.Tensor) -> torch.Tensor:
        if self.scale_mode == "unit_cube":
            return local_points / (2.0 * self.field_radius) + 0.5
        if self.scale_mode == "unit_ball":
            return local_points / self.field_radius
        return local_points

    def world_to_local(self, query_points, field_positions, field_orientations):
        """World -> field-local (+ scale), 2D or 3D; broadcasts over points."""
        local = query_points - field_positions
        local = self._orientation_apply(self._orientation_invert(field_orientations), local)
        return self._scale_local_points(local)

    def apply_vmap(
        self,
        vmap_params: Params,
        query_points: torch.Tensor,  # (F, P, dim_points) world (local if no pose)
        field_positions: Optional[torch.Tensor] = None,  # (F, dim_points)
        field_orientations: Optional[torch.Tensor] = None,  # (F, 2 or 4)
    ) -> torch.Tensor:
        """Field-parallel evaluation through :meth:`NeuralField.apply` (the
        gather route) -> (F, P, dim_out)."""
        if field_positions is not None:
            local = self.world_to_local(
                query_points, field_positions[:, None, :], field_orientations[:, None, :]
            )
        else:
            local = self._scale_local_points(query_points)
        return self.prototype.apply(vmap_params, local)

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

    def apply_vmap_fm(
        self,
        vmap_params: Params,
        query_points: torch.Tensor,  # (F, P, 3) world (local if no pose)
        field_positions: Optional[torch.Tensor] = None,  # (F, 3)
        field_orientations: Optional[torch.Tensor] = None,  # (F, 4)
    ) -> torch.Tensor:
        """Feature-major field-parallel evaluation -> (F, dim_out, P), through
        the training path's :meth:`NeuralField.apply_fm_soa`."""
        if field_positions is None:
            return self.prototype.apply_fm_soa(vmap_params, self._scale_local_points(query_points).unbind(-1))
        return self.apply_vmap_fm_soa(
            vmap_params, query_points.unbind(-1), field_positions, field_orientations
        )

    def supports_tiled_knn(self) -> bool:
        """True when the tiled MoE inference path applies: 3D permutohedral
        encoding with 2 features per level (the MoE kernels' shape) and no
        concatenated points."""
        from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

        enc = self.prototype.encoding
        return (
            isinstance(enc, PermutohedralEncoding)
            and enc.pos_dim == 3
            and enc.nr_feat_per_level == 2
            and not enc.concat_points
            and self.dim_points == 3
        )

    def _mlp_epilogue(self, stacked_params: Params) -> Optional[tuple]:
        """The stacked (w0, b0, w1, b1) that the MoE encode takes to run the
        field MLP as its epilogue (``permuto_cuda.encode_fwd_moe*``'s
        ``mlp``), where the field is one the fused kernels take
        (:meth:`NeuralField._supports_fused_mlp`: one hidden layer, no skip,
        the kernels' widths); else None, and the dispatch runs
        :meth:`NeuralField.mlp_fm`."""
        if not self.prototype._supports_fused_mlp():
            return None
        return tuple(stacked_params[k] for k in ("w0", "b0", "w1", "b1"))

    def _coord_scale_shift(self):
        if self.scale_mode == "unit_cube":
            return 1.0 / (2.0 * self.field_radius), 0.5
        if self.scale_mode == "unit_ball":
            return 1.0 / self.field_radius, 0.0
        return 1.0, 0.0

    def apply_knn_tiled(
        self,
        stacked_params: Params,
        query_points: torch.Tensor,  # (P, 3) world
        field_positions: torch.Tensor,  # (N, 3)
        field_orientations: torch.Tensor,  # (N, 4) wxyz
        field_valid: torch.Tensor,  # (N,) bool
        field_radius: Optional[float] = None,
        ray_ctx: Optional[dict] = None,
        routing: Optional[tuple] = None,
        partial_blend: bool = False,
    ) -> torch.Tensor:
        """KNN-blended evaluation through the tile-sorted MoE dispatch
        (fields.apply_knn_tiled) -> (P, dim_out).

        ``field_radius`` overrides the radius of the inside test (meshing's
        recolour pass takes the field set's radius + 0.1); field-local
        coordinates keep the field set's own scale.

        Every valid (point, neighbour) pair is sorted by field into
        TILE-pair tiles that each belong to one field, encoded by one MoE
        kernel launch, pushed through the MLP with per-tile weights, and put
        back in pair order. The MoE kernel runs the MLP itself where it can
        (:meth:`_mlp_epilogue`: one hidden layer, no skip, the kernels'
        widths); any other MLP runs as :meth:`NeuralField.mlp_fm` over
        every tile. Points whose nearest field is beyond the radius get
        ``outside_value``. No per-field capacity, no dropped pairs.
        While tracing, each stage is a span ``ngm.render.*``, and the
        counters ``render.pairs_valid``, ``render.lanes_encoded`` and
        ``render.lanes_mlp`` add the pairs inside a radius and the lanes
        the encode and the MLP run, ``render.mlp_fused`` the dispatches
        whose MLP ran in the encode (``utils/profiling.py``).

        Routing, as the JAX package at its defaults: k = 2 runs the
        ``topk2_fields`` kernel and keeps pairs k-major (pair i of rank kk
        at kk * P + i); other k run :func:`dispatch.topk_fields` with k-minor
        pairs. ``ray_ctx`` (render blocks whose k * samples is a power of
        two) = {"dist": (P,) span distances, "ray_params": (16,),
        "block_offset": int, "log2_ks": int, "width": int}: the encode then
        rebuilds each sample point in the kernel (``encode_fwd_moe_rays``)
        instead of carrying coordinates through the sort
        (``encode_fwd_moe``). No host sync: the live-tile count stays on the
        device.

        ``routing`` (field-sharded evaluation, ``parallel/sharding.py``):
        ``(distances (P, k) GLOBAL, ids (P, k) LOCAL rows of
        ``stacked_params``, owned (P, k) bool, inside (P,) bool)`` replaces
        the top-k; only owned pairs evaluate, and the field poses are this
        rank's rows. With ``partial_blend`` the result is this rank's
        weighted contribution, zeros where no owned pair lies and no
        ``outside_value`` fill: the sum over ranks is the blend, since its
        weights come from the global distances.
        """
        radius = self.field_radius if field_radius is None else field_radius
        k = self.num_knn
        n = stacked_params["enc.table"].shape[0]
        p = query_points.shape[0]
        tile = permuto_cuda.TILE
        enc = self.prototype.encoding
        m = p * k

        with profiling.span("ngm.render.route"):
            k_major = k == 2
            if routing is not None:
                dists, ids, owned, inside = routing
                if k_major:
                    d_fm = dists.T
                    valid_fm = torch.isfinite(d_fm) & inside[None, :]
                    owned_fm = valid_fm & owned.T
                    pair_ids = ids.T.reshape(-1)
                    pair_valid = owned_fm.reshape(-1)
                else:
                    knn_dists = dists
                    pair_ids = ids.reshape(-1)
                    pair_valid = (
                        owned.reshape(-1) & torch.repeat_interleave(inside, k) & torch.isfinite(dists.reshape(-1))
                    )
            elif k_major:
                d_fm, i_fm = topk.topk2_fields(
                    query_points.T.contiguous(), field_positions.contiguous(), field_valid
                )  # (2, P)
                inside = d_fm[0] < radius
                valid_fm = owned_fm = torch.isfinite(d_fm) & inside[None, :]
                pair_ids = i_fm.reshape(-1)
                pair_valid = valid_fm.reshape(-1)
            else:
                knn_dists, knn_idx = dispatch.topk_fields(query_points, field_positions, field_valid, k)
                inside = knn_dists[:, 0] < radius
                pair_ids = knn_idx.reshape(-1)
                pair_valid = torch.repeat_interleave(inside, k) & torch.isfinite(knn_dists.reshape(-1))

        with profiling.span("ngm.render.dispatch"):
            def pairs_of(x):  # (P,) point payload -> (M,) in pair order
                return x.repeat(k) if k_major else torch.repeat_interleave(x, k)

            if ray_ctx is not None:
                payloads = (pairs_of(ray_ctx["dist"]),)
            else:
                payloads = tuple(pairs_of(query_points[:, i]) for i in range(3))
            (
                sorted_payloads, sorted_orig, tile_src, tile_expert, tile_count, num_live, num_tiles,
            ) = dispatch.tiled_dispatch_sorted(pair_ids, pair_valid, payloads, n, tile)

            # per-tile contiguous slices of the (one-tile padded) sorted arrays
            lane = torch.arange(tile, device=query_points.device)
            src = tile_src.long()[:, None] + lane[None, :]  # (tiles, TILE)

            def tile_buffer(x):
                return torch.cat([x, x.new_zeros(tile)])[src]

            buf_orig = tile_buffer(sorted_orig)
            te = tile_expert.long()
            mlp = self._mlp_epilogue(stacked_params)
            if profiling.tracing_on():  # pairs inside a radius against the lanes run
                live = torch.arange(num_tiles, device=tile_count.device) < num_live
                profiling.count("render.pairs_valid", torch.where(live, tile_count, 0).sum())
                lanes_live = num_live.to(torch.int64) * tile
                profiling.count("render.lanes_encoded", lanes_live)
                profiling.count("render.lanes_mlp", num_tiles * tile if mlp is None else lanes_live)
                if mlp is not None:
                    profiling.count("render.mlp_fused")

        with profiling.span("ngm.render.encode"):
            consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
            table = stacked_params["enc.table"]
            if ray_ctx is not None:
                # the ray kernel derives the ray from a k-MINOR pair index
                kern_orig = (buf_orig % p) * k + buf_orig // p if k_major else buf_orig
                cs, csh = self._coord_scale_shift()
                field_poses = torch.cat([field_positions, field_orientations], dim=-1).contiguous()
                outs = permuto_cuda.encode_fwd_moe_rays(
                    table, kern_orig.contiguous(), tile_buffer(sorted_payloads[0]), tile_expert,
                    ray_ctx["ray_params"], field_poses, ray_ctx["block_offset"], *consts,
                    log2_ks=ray_ctx["log2_ks"], width=ray_ctx["width"], coord_scale=cs,
                    coord_shift=csh, num_live_tiles=num_live, mlp=mlp,
                )  # with mlp (tiles, dim_out, TILE), else the features (tiles, 2L, TILE)
            else:
                bx, by, bz = (tile_buffer(c) for c in sorted_payloads)
                local = self.world_to_local_soa((bx, by, bz), field_positions[te], field_orientations[te])
                outs = permuto_cuda.encode_fwd_moe(
                    table, torch.stack(local, dim=1).contiguous(), tile_expert, *consts,
                    num_live_tiles=num_live, mlp=mlp,
                )

        if mlp is None:
            with profiling.span("ngm.render.mlp"):
                mlp_params = {key: v[te] for key, v in stacked_params.items() if not key.startswith("enc.")}
                outs = self.prototype.mlp_fm(mlp_params, outs)  # (tiles, dim_out, TILE)

        with profiling.span("ngm.render.scatter_blend"):
            dim_out = self.prototype.dim_out
            # back to pair order: one scatter by the carried pair index (real
            # lanes' keys are unique; padding lanes all land in the dump slot m)
            bkey = torch.where(lane[None, :] < tile_count[:, None], buf_orig, m).long().reshape(-1)
            flat_fm = outs.permute(1, 0, 2).reshape(dim_out, num_tiles * tile)
            pair_outs = outs.new_empty((dim_out, m + 1)).index_copy_(1, bkey, flat_fm)[:, :m]

            if k_major:
                # feature-major softmax blend over the (k, P) kernel outputs;
                # invalid pairs get weight 0 by SELECT (dead tiles may hold NaN),
                # and so do pairs another rank evaluates (never written here)
                logits = torch.where(valid_fm, -self.distance_factor * d_fm, -torch.inf)
                mx = torch.amax(logits, dim=0)
                e = torch.exp(logits - torch.where(torch.isfinite(mx), mx, 0.0)[None, :])
                e = torch.where(valid_fm, e, 0.0)
                w = e / torch.clamp(torch.sum(e, dim=0), min=1e-38)[None, :]  # (k, P)
                per_rank = pair_outs.reshape(dim_out, k, p)
                blended = sum(
                    torch.where(owned_fm[kk][None, :], per_rank[:, kk] * w[kk][None, :], 0.0)
                    for kk in range(k)
                ).T  # (P, dim_out)
            else:
                pair_outs = torch.where(pair_valid[None, :], pair_outs, 0.0)
                logits = -self.distance_factor * knn_dists
                logits = torch.where(torch.isfinite(knn_dists) & inside[:, None], logits, -torch.inf)
                safe_logits = torch.where(inside[:, None], logits, 0.0)
                weights = torch.softmax(safe_logits, dim=-1)  # (P, k)
                blended = torch.einsum("cpk,pk->pc", pair_outs.reshape(dim_out, p, k), weights)
            if partial_blend:
                return torch.where(inside[:, None], blended, 0.0)
            return torch.where(inside[:, None], blended, self.outside_value)

    def apply_knn(
        self,
        stacked_params: Params,
        query_points: torch.Tensor,  # (P, dim_points) world
        field_positions: torch.Tensor,  # (N, dim_points)
        field_orientations: torch.Tensor,  # (N, 2 or 4)
        field_valid: torch.Tensor,  # (N,) bool
        capacity: int,
        field_radius: Optional[float] = None,
        num_knn: Optional[int] = None,
        with_stats: bool = False,
    ):
        """KNN-blended evaluation through the capacity-buffer dispatch
        (fields.apply_knn) -> (P, dim_out), or ``(outputs, dropped)`` with
        ``with_stats`` (dropped: the valid pairs past capacity, a 0-d int64
        tensor).

        Every (point, neighbour) pair goes to its field's buffer of
        ``capacity`` slots (:func:`dispatch.expert_eval`, which evaluates
        the buffer through :meth:`NeuralField.apply`, the gather route);
        pairs beyond a field's capacity are DROPPED and the softmax blend
        renormalises over the pairs that survive. Points whose nearest field
        is beyond the radius, or whose pairs were all dropped, get
        ``outside_value``. The top-k is :func:`dispatch.topk_fields`, the
        expanded distance form, as JAX computes it on this route.
        ``field_radius`` and ``num_knn`` override the set's own.
        """
        radius = self.field_radius if field_radius is None else field_radius
        k = self.num_knn if num_knn is None else num_knn
        n = self.num_fields(stacked_params)
        p = query_points.shape[0]

        knn_dists, knn_idx = dispatch.topk_fields(query_points, field_positions, field_valid, k)
        inside = knn_dists[:, 0] < radius  # the radius gate: nearest field only
        pair_points = torch.repeat_interleave(query_points, k, dim=0)  # (P*k, d)
        pair_ids = knn_idx.reshape(-1)
        pair_valid = torch.repeat_interleave(inside, k) & torch.isfinite(knn_dists.reshape(-1))

        def apply_fn(packed, pts):  # a slice of E experts, pts (E, C, d)
            local = self.world_to_local(pts, packed["pos"][:, None, :], packed["quat"][:, None, :])
            return self.prototype.apply(packed["params"], local)

        packed = {"params": stacked_params, "pos": field_positions, "quat": field_orientations}
        dim_out = self.prototype.dim_out
        pair_outs, kept = dispatch.expert_eval(
            apply_fn, packed, pair_points, pair_ids, pair_valid, n, capacity, dim_out
        )
        pair_outs = pair_outs.reshape(p, k, dim_out)
        kept = kept.reshape(p, k)

        logits = torch.where(kept, -self.distance_factor * knn_dists, -torch.inf)
        any_kept = torch.any(kept, dim=-1)
        weights = torch.softmax(torch.where(any_kept[:, None], logits, 0.0), dim=-1)
        blended = torch.sum(weights[..., None] * pair_outs, dim=-2)
        out = torch.where((inside & any_kept)[:, None], blended, self.outside_value)
        if with_stats:
            return out, torch.sum(pair_valid & ~kept.reshape(-1))
        return out
