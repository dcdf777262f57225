"""Training-target samplers (port of neural_graph_mapping_tpu.mapping.sampling:
the multi-view and the single-view sampler, and the observed-field test).

Static shapes and validity masks, as in the JAX package. Every random draw is
an optional tensor argument: when it is not given, it is drawn from the
``generator`` (a ``torch.Generator`` on the tensors' device). Tests pass the
JAX package's own draws to compare the deterministic math exactly.

- Gumbel-top-k draws take the uniforms ``u`` (the JAX code draws
  ``jax.random.uniform`` and transforms them).
- Categorical draws take the Gumbel noise (``jax.random.categorical`` is
  ``argmax(logits + gumbel)`` over a noise tensor of the documented shape).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from neural_graph_mapping_tpu_torch import geometry
from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.ops import permuto_cuda
from neural_graph_mapping_tpu_torch.utils import transforms


class Target(NamedTuple):
    """Supervision targets for one optimization iteration, plus a per-field
    validity mask."""

    ijs: torch.Tensor  # (F, R, 2) int pixel (row, col)
    c2ws: torch.Tensor  # (F, R, 4, 4) camera-to-world per ray
    near_distances: torch.Tensor  # (F, R)
    far_distances: torch.Tensor  # (F, R)
    gt_distances: torch.Tensor  # (F, R) 0 = unavailable
    field_ids: torch.Tensor  # (F,)
    field_valid: torch.Tensor  # (F,) False -> all its rays masked out
    rgbds: torch.Tensor  # (F, R, 4)
    rgb_mask: torch.Tensor  # (F, R)
    depth_mask: torch.Tensor  # (F, R)
    term_probs: torch.Tensor  # (F, R)
    term_mask: torch.Tensor  # (F, R)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)), U ~ U(tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def masked_choice_without_replacement(
    mask: torch.Tensor,
    k: int,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw up to k distinct indices where mask is True (Gumbel top-k).

    ``u``: uniforms of ``mask``'s shape. Returns idx (k,) (arbitrary where
    invalid) and valid (k,).
    """
    if u is None:
        u = torch.rand(mask.shape, generator=generator, device=mask.device)
    gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    scores = torch.where(mask, gumbel, torch.full_like(gumbel, -torch.inf))
    top, idx = torch.topk(scores, k)
    return idx, torch.isfinite(top)


def select_target_fields(
    observed_mask: torch.Tensor,  # (N_cap,) currently-observed fields
    allocated_mask: torch.Tensor,  # (N_cap,) fields that exist
    num_train_fields: int,
    u_obs: Optional[torch.Tensor] = None,  # (N_cap,)
    u_rand: Optional[torch.Tensor] = None,  # (N_cap,)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half currently-observed, half random fields; missing observed slots
    are backfilled with extra random fields. Invalid slots point at field 0,
    as in the JAX package. Returns (field_ids (F,), field_valid (F,))."""
    k_obs = num_train_fields // 2
    obs_ids, obs_ok = masked_choice_without_replacement(
        observed_mask & allocated_mask, k_obs, u_obs, generator
    )
    chosen = torch.zeros_like(allocated_mask)
    chosen[obs_ids] = obs_ok
    rand_mask = allocated_mask & ~chosen
    rand_ids, rand_ok = masked_choice_without_replacement(
        rand_mask, num_train_fields, u_rand, generator
    )
    k_rand = num_train_fields - k_obs
    fill_idx = k_rand + torch.cumsum((~obs_ok).long(), 0) - 1  # rank among invalid slots
    fill_idx = torch.clamp(fill_idx, 0, num_train_fields - 1)
    obs_ids = torch.where(obs_ok, obs_ids, rand_ids[fill_idx])
    obs_ok = obs_ok | (~obs_ok & rand_ok[fill_idx])
    field_ids = torch.cat([obs_ids, rand_ids[:k_rand]])
    field_valid = torch.cat([obs_ok, rand_ok[:k_rand]])
    field_ids = torch.where(field_valid, field_ids, torch.zeros_like(field_ids))
    return field_ids, field_valid


# view points drawn by the observed-field test (the JAX package's default)
OBSERVED_NUM_POINTS = 500


def observed_fields_mask(
    camera: Camera,
    depth_image: torch.Tensor,  # (H, W)
    c2w: torch.Tensor,  # (4, 4)
    field_positions: torch.Tensor,  # (N_cap, 3)
    allocated_mask: torch.Tensor,  # (N_cap,)
    field_radius: float,
    num_points: int = OBSERVED_NUM_POINTS,
    gumbel: Optional[torch.Tensor] = None,  # (num_points, H*W)
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Which fields intersect view rays of the current frame -> (N_cap,) bool.
    View points are drawn with replacement among the valid depth pixels."""
    points, _, valid = camera.depth_to_points_full(depth_image, "opengl")
    logits = torch.log(valid.float() + 1e-20)
    if gumbel is None:
        gumbel = gumbel_noise((num_points, logits.shape[0]), generator, logits.device)
    sel = torch.argmax(gumbel + logits, dim=-1)
    pts = points[sel]
    pts_ok = valid[sel]
    field_pos_c = transforms.transform_points(field_positions, c2w, inv=True)
    hits = geometry.segments_intersect_spheres(
        torch.zeros_like(pts), pts, field_pos_c, field_radius
    )
    hits = hits & pts_ok[None, :]
    return torch.any(hits, dim=-1) & allocated_mask


def _visibility_depths(
    cache_depth: torch.Tensor,  # (S, H, W)
    ys: torch.Tensor,  # (F, K, S) clipped pixel rows
    xs: torch.Tensor,  # (F, K, S) clipped pixel cols
) -> torch.Tensor:
    """Cached depth at each projected sphere sample in each keyframe slot ->
    (F, K, S), through the ``batched_gather`` kernel. Exact per-pixel depths
    (the JAX package's CPU semantics, not its TPU max-pooling)."""
    s, h, w = cache_depth.shape
    f, k, _ = ys.shape
    flat_t = (ys * w + xs).permute(2, 0, 1).reshape(s, f * k).contiguous()  # slot-major
    got = permuto_cuda.batched_gather(cache_depth.reshape(s, h * w), flat_t)
    return got.reshape(s, f, k).permute(1, 2, 0)


def sample_target_mv(
    camera: Camera,
    field_ids: torch.Tensor,  # (F,) pre-selected target fields
    field_valid: torch.Tensor,  # (F,)
    field_positions: torch.Tensor,  # (N_cap, 3)
    cache_rgb: torch.Tensor,  # (S, H, W, 3)
    cache_depth: torch.Tensor,  # (S, H, W)
    cache_c2w: torch.Tensor,  # (S, 4, 4)
    cache_valid: torch.Tensor,  # (S,) slot holds a frame
    field_radius: float,
    num_rays_per_field: int,
    num_field_samples: int = 20,
    offsets: Optional[torch.Tensor] = None,  # (num_field_samples, 3) ~ N(0, 1)
    kf_gumbel: Optional[torch.Tensor] = None,  # (F, R, S) Gumbel noise
    pix_u: Optional[torch.Tensor] = None,  # (F, R, 2) ~ U(0, 1)
    generator: Optional[torch.Generator] = None,
) -> Target:
    """Multi-view target sampler: sphere-surface samples projected into every
    cached keyframe give the field<->keyframe visibility; each ray draws a
    visible keyframe, then a pixel uniform in the projected 2D bbox."""
    f = field_ids.shape[0]
    s = cache_c2w.shape[0]
    r = num_rays_per_field
    h, w = cache_depth.shape[1], cache_depth.shape[2]
    dev = cache_depth.device
    if offsets is None:
        offsets = torch.randn((num_field_samples, 3), generator=generator, device=dev)
    if kf_gumbel is None:
        kf_gumbel = gumbel_noise((f, r, s), generator, dev)
    if pix_u is None:
        pix_u = torch.rand((f, r, 2), generator=generator, device=dev)

    field_pos_w = field_positions[field_ids]  # (F, 3)
    offsets = offsets / torch.linalg.vector_norm(offsets, dim=-1, keepdim=True)
    samples_w = field_pos_w[:, None, :] + offsets[None] * field_radius  # (F, K, 3)

    samples_c = transforms.transform_points(
        samples_w[:, :, None, :], cache_c2w[None, None], inv=True
    )  # (F, K, S, 3)
    sample_depths = -samples_c[..., 2]
    xy, _ = camera.project_points(samples_c, "opengl")  # (F, K, S, 2)
    xs = xy[..., 0].long()
    ys = xy[..., 1].long()
    in_frustum = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)

    xs_c = torch.clamp(xs, 0, w - 1)
    ys_c = torch.clamp(ys, 0, h - 1)
    kf_depths = _visibility_depths(cache_depth, ys_c, xs_c)
    kf_depths = torch.where(in_frustum, kf_depths, torch.zeros_like(kf_depths))

    in_front = torch.any(sample_depths > 0, dim=1)  # (F, S)
    closer = torch.any(sample_depths < kf_depths, dim=1)
    in_any_frustum = torch.any(in_frustum, dim=1)
    field_kf_mask = in_front & closer & in_any_frustum & cache_valid[None, :]

    visible = torch.any(field_kf_mask, dim=-1)  # (F,)
    field_valid = field_valid & visible

    # keyframe per ray ~ visibility mask (with replacement)
    zero = torch.zeros((), device=dev)
    logits = torch.where(field_kf_mask, zero, torch.full_like(zero, -torch.inf))
    safe_logits = torch.where(visible[:, None], logits, zero)  # avoid all -inf rows
    target_slots = torch.argmax(kf_gumbel + safe_logits[:, None, :], dim=-1)  # (F, R)

    # per-(field, slot) projected-sample bbox
    big = 1e9
    inf3 = in_frustum[..., None]
    min_xy_all = torch.amin(torch.where(inf3, xy, torch.full_like(xy, big)), dim=1)  # (F, S, 2)
    max_xy_all = torch.amax(torch.where(inf3, xy, torch.full_like(xy, -big)), dim=1)
    min_xy_all = torch.clamp(min_xy_all, min=0.0)
    wh = torch.tensor([float(w), float(h)], device=dev)
    max_xy_all = torch.minimum(max_xy_all, wh)
    slot_idx = target_slots[..., None].expand(f, r, 2)
    min_xy = torch.gather(min_xy_all, 1, slot_idx)  # (F, R, 2)
    max_xy = torch.gather(max_xy_all, 1, slot_idx)
    max_xy = torch.maximum(max_xy, min_xy)  # degenerate bbox -> single pixel

    target_xy = (max_xy - min_xy) * pix_u + min_xy
    target_ji = torch.minimum(target_xy.long(), torch.tensor([w - 1, h - 1], device=dev))
    target_ijs = torch.stack([target_ji[..., 1], target_ji[..., 0]], dim=-1)

    target_c2ws = cache_c2w[target_slots]  # (F, R, 4, 4)

    field_pos_c = transforms.transform_points(field_pos_w[:, None, :], target_c2ws, inv=True)
    ijs_f = target_ijs.float()
    dirs = camera.ijs_to_directions(ijs_f)
    center_distance = torch.sum(field_pos_c * dirs, dim=-1)
    near = torch.clamp(center_distance - field_radius, min=0.0)
    far = torch.clamp(center_distance + field_radius, min=0.0)

    rows = target_ijs[..., 0]
    cols = target_ijs[..., 1]
    rgb = cache_rgb[target_slots, rows, cols].float()  # (F, R, 3)
    depth = cache_depth[target_slots, rows, cols]  # (F, R)
    rgbds = torch.cat([rgb, depth[..., None]], dim=-1)
    gt_distances = camera.depth_to_distance(depth, ijs_f)
    valid_depth = gt_distances != 0.0
    depth_mask = (gt_distances > near) & (gt_distances < far) & valid_depth
    rgb_mask = torch.any(rgbds[..., :2] != 0.0, dim=-1)
    term_probs = (gt_distances < far).float()
    term_mask = (gt_distances > near) & valid_depth

    fv = field_valid[:, None]
    return Target(
        ijs=target_ijs,
        c2ws=target_c2ws,
        near_distances=near,
        far_distances=far,
        gt_distances=gt_distances,
        field_ids=field_ids,
        field_valid=field_valid,
        rgbds=rgbds,
        rgb_mask=rgb_mask & fv,
        depth_mask=depth_mask & fv,
        term_probs=term_probs,
        term_mask=term_mask & fv,
    )


def sample_target_sv(
    camera: Camera,
    rgbd_image: torch.Tensor,  # (H, W, 4)
    c2w: torch.Tensor,  # (4, 4)
    field_positions: torch.Tensor,  # (N_cap, 3)
    active_mask: torch.Tensor,  # (N_cap,)
    field_radius: float,
    num_train_fields: int,
    num_rays_per_field: int,
    num_cloud_points: int = 50_000,
    cloud_chunk: int = 8192,
    cloud_idx: Optional[torch.Tensor] = None,  # (num_cloud_points,) pixel indices
    u_fields: Optional[torch.Tensor] = None,  # (N_cap,) Gumbel uniforms
    u_rays: Optional[torch.Tensor] = None,  # (F, R) ~ U(0, 1)
    generator: Optional[torch.Generator] = None,
) -> Target:
    """Single-view target sampler: the view's depth cloud against the active
    field spheres.

    1. ``num_cloud_points`` pixels are drawn with replacement among the
       valid depth pixels (``cloud_idx``; JAX draws them by ``categorical``).
    2. Each field's count of cloud segments (camera -> point) that cross
       its sphere, streamed over ``cloud_chunk``-point slices of the cloud,
       so the peak is (N_cap, chunk), not (N_cap, num_cloud_points).
    3. Fields with at least R such segments are eligible; F of them are
       drawn without replacement (``u_fields``, Gumbel top-k).
    4. For the F chosen fields only, the dense hit mask; each field's R rays
       are drawn uniformly among its hit segments by inverse CDF
       (``u_rays``; ``searchsorted`` on the right, clipped as JAX clips).
    """
    f, r = num_train_fields, num_rays_per_field
    dev = rgbd_image.device
    points, ijs, valid = camera.depth_to_points_full(rgbd_image[..., 3], "opengl")
    if cloud_idx is None:
        probs = torch.where(valid, 1.0, 1e-20)
        cloud_idx = torch.multinomial(probs, num_cloud_points, replacement=True, generator=generator)
    if u_rays is None:
        u_rays = torch.rand((f, r), generator=generator, device=dev)
    pts = points[cloud_idx]
    pts_ok = valid[cloud_idx]
    pt_ijs = ijs[cloud_idx]

    field_pos_c = transforms.transform_points(field_positions, c2w, inv=True)
    origin = torch.zeros((1, 3), device=dev)

    # 1) streamed per-field hit counts over the cloud
    counts = torch.zeros(field_positions.shape[0], dtype=torch.int64, device=dev)
    for s0 in range(0, pts.shape[0], cloud_chunk):
        p_c = pts[s0 : s0 + cloud_chunk]
        hit = geometry.segments_intersect_spheres(origin.expand_as(p_c), p_c, field_pos_c, field_radius)
        hit = hit & pts_ok[None, s0 : s0 + cloud_chunk] & active_mask[:, None]
        counts += torch.sum(hit, dim=-1)

    eligible = counts >= num_rays_per_field
    field_ids, field_valid = masked_choice_without_replacement(eligible, f, u_fields, generator)

    # 2) dense hit mask for the chosen fields only; inverse-CDF ray draws
    field_hits = geometry.segments_intersect_spheres(
        origin.expand_as(pts), pts, field_pos_c[field_ids], field_radius
    ) & pts_ok[None, :]  # (F, P)
    w = torch.where(field_valid[:, None], field_hits, True).float()
    cdf = torch.cumsum(w, dim=-1)
    u = u_rays * cdf[:, -1:]
    segments = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, w.shape[-1] - 1)

    target_ijs = pt_ijs[segments]  # (F, R, 2)
    ijs_f = target_ijs.float()
    dirs = camera.ijs_to_directions(ijs_f)
    pos_c = field_pos_c[field_ids]  # (F, 3)
    center_distance = torch.sum(pos_c[:, None, :] * dirs, dim=-1)
    near = center_distance - field_radius
    far = center_distance + field_radius

    rgbds = rgbd_image[target_ijs[..., 0], target_ijs[..., 1]]
    gt_distances = camera.depth_to_distance(rgbds[..., 3], ijs_f)
    depth_mask = gt_distances < far
    fv = field_valid[:, None]
    return Target(
        ijs=target_ijs,
        c2ws=c2w.expand(f, r, 4, 4),
        near_distances=near,
        far_distances=far,
        gt_distances=gt_distances,
        field_ids=field_ids,
        field_valid=field_valid,
        rgbds=rgbds,
        rgb_mask=depth_mask & fv,
        depth_mask=depth_mask & fv,
        term_probs=depth_mask.float(),
        term_mask=torch.ones_like(depth_mask) & fv,
    )
