"""Ray rendering for training (port of neural_graph_mapping_tpu.mapping.render,
field-parallel path): stratified coarse plus depth-guided samples, world
transform, field evaluation, residual masks and quadrature."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.mapping.sampling import Target
from neural_graph_mapping_tpu_torch.ops import quadrature


class RenderConfig(NamedTuple):
    """Rendering hyperparameters (subset of config/neural_graph_map.yaml)."""

    geometry_mode: str = "nrgbd"
    geometry_factor: float = 20.0
    color_factor: float = 1.0
    num_samples_coarse: int = 8
    num_samples_depth_guided: int = 16
    range_depth_guided: float = 0.1  # defaults to truncation_distance
    truncation_distance: float = 0.1
    freespace: bool = True
    tsdf: bool = True


class Prediction(NamedTuple):
    """Per-ray render outputs + per-sample residual ingredients."""

    rgbds: torch.Tensor  # (F, R, 4)
    color_vars: torch.Tensor  # (F, R, 3)
    depth_vars: torch.Tensor  # (F, R)
    term_probs: torch.Tensor  # (F, R)
    sample_geometries: torch.Tensor  # (F, R, S)
    sample_distances: torch.Tensor  # (F, R, S)
    freespace_mask: torch.Tensor  # (F, R, S)
    tsdf_mask: torch.Tensor  # (F, R, S)


def sample_ray_distances(
    near: torch.Tensor,  # (F, R)
    far: torch.Tensor,  # (F, R)
    gt_distances: Optional[torch.Tensor],  # (F, R) or None
    cfg: RenderConfig,
    u_coarse: Optional[torch.Tensor] = None,  # (F, R, coarse) ~ U(0, 1)
    u_guided: Optional[torch.Tensor] = None,  # (F, R, guided) ~ U(0, 1)
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stratified coarse + depth-guided distances, sorted -> (F, R, S)."""
    lead = tuple(near.shape)
    dev = near.device
    sc = cfg.num_samples_coarse
    if u_coarse is None:
        u_coarse = torch.rand(lead + (sc,), generator=generator, device=dev)
    edges = torch.linspace(0.0, 1.0, sc + 1, device=dev)[:-1]
    span = far - near
    coarse = near[..., None] + span[..., None] * (edges + u_coarse / sc)

    if cfg.num_samples_depth_guided <= 0 or gt_distances is None:
        return coarse

    sg = cfg.num_samples_depth_guided
    if u_guided is None:
        u_guided = torch.rand(lead + (sg,), generator=generator, device=dev)
    # rays without usable depth fall back to uniform near/far
    bad = (gt_distances == 0.0) | (near > gt_distances) | (far < gt_distances)
    g_near = torch.where(bad, near, gt_distances - cfg.range_depth_guided)
    g_far = torch.where(bad, far, gt_distances + cfg.range_depth_guided)
    edges_g = torch.linspace(0.0, 1.0, sg + 1, device=dev)[:-1]
    guided = g_near[..., None] + (g_far - g_near)[..., None] * (edges_g + u_guided / sg)
    return torch.sort(torch.cat([coarse, guided], dim=-1), dim=-1).values


def render_rays_vmap(
    fset,
    sub_params,
    field_positions: torch.Tensor,  # (F, 3) world poses of the target fields
    field_orientations: torch.Tensor,  # (F, 4)
    camera: Camera,
    target: Target,
    cfg: RenderConfig,
    u_coarse: Optional[torch.Tensor] = None,
    u_guided: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Prediction:
    """Field-parallel training render of the target's rays through the
    gathered fields ``sub_params`` (leading axis F)."""
    f, r = target.near_distances.shape
    distances = sample_ray_distances(
        target.near_distances, target.far_distances, target.gt_distances, cfg,
        u_coarse, u_guided, generator,
    )  # (F, R, S)
    s = distances.shape[-1]

    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.0)
    rows = target.ijs[..., 0].float()
    cols = target.ijs[..., 1].float()
    dx = (cols - cx) / fx
    dy = -(rows - cy) / fy
    inv_norm = 1.0 / torch.sqrt(dx * dx + dy * dy + 1.0)  # opengl: dz = -1
    dxn = dx * inv_norm
    dyn = dy * inv_norm
    dzn = -inv_norm

    pcx = dxn[..., None] * distances  # camera-frame sample coords (F, R, S)
    pcy = dyn[..., None] * distances
    pcz = dzn[..., None] * distances

    c = target.c2ws  # (F, R, 4, 4)

    def coef(i, j):
        return c[..., i, j][..., None]

    wx = coef(0, 0) * pcx + coef(0, 1) * pcy + coef(0, 2) * pcz + coef(0, 3)
    wy = coef(1, 0) * pcx + coef(1, 1) * pcy + coef(1, 2) * pcz + coef(1, 3)
    wz = coef(2, 0) * pcx + coef(2, 1) * pcy + coef(2, 2) * pcz + coef(2, 3)

    outs = fset.apply_vmap_fm_soa(
        sub_params,
        (wx.reshape(f, r * s), wy.reshape(f, r * s), wz.reshape(f, r * s)),
        field_positions,
        field_orientations,
    )  # (F, 4, R*S)

    sample_colors = cfg.color_factor * outs[:, :3, :].reshape(f, 3, r, s)
    sample_geometries = outs[:, 3, :].reshape(f, r, s)
    sample_depths = -pcz

    # behind-camera samples forced to empty space
    behind = pcz > 0
    empty = -100.0 if cfg.geometry_mode in ("occupancy", "density") else 1.0
    sample_geometries = torch.where(behind, torch.full_like(sample_geometries, empty), sample_geometries)

    gt = target.gt_distances[..., None]
    has_depth = gt != 0.0
    freespace_mask = (distances < (gt - cfg.truncation_distance)) & has_depth
    tsdf_mask = (torch.abs(gt - distances) < cfg.truncation_distance) & has_depth

    neus_isds = None
    if cfg.geometry_mode == "neus":
        neus_isds = 1.0 / torch.abs(sub_params["neus_sd"]).reshape(f, 1, 1)

    q = quadrature.quadrature_fm(
        cfg.geometry_mode,
        sample_colors,
        sample_geometries,
        distances,
        sample_depths,
        geometry_factor=cfg.geometry_factor,
        neus_isds=neus_isds,
    )

    fv = target.field_valid[:, None, None]
    return Prediction(
        rgbds=torch.cat([q.colors.transpose(1, 2), q.depths[..., None]], dim=-1),
        color_vars=q.color_vars.transpose(1, 2),
        depth_vars=q.depth_vars,
        term_probs=q.term_probs,
        sample_geometries=sample_geometries,
        sample_distances=distances,
        freespace_mask=freespace_mask & fv,
        tsdf_mask=tsdf_mask & fv,
    )
