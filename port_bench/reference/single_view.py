"""A plain single-view target draw, in float32 ``torch``, for the comparison
with the program's single-view sampler (``mapping/sampling.sample_target_sv``
and the view choice of ``mapping/engine.optimization_iteration_sv``).

It is written from the reference's description of its single-view mode
(``run_mapping.py``: the view choice at ``:1126-1149``, ``_sample_target_sv``
at ``:1463``) and imports nothing of the program, of its frozen copy
(``port_bench/reference/ngm``) or of JAX. One iteration:

1. The view (:func:`choose_view`): odd iterations train on the current
   frame, slot 0 of the keyframe cache, if it holds one; the others on a
   random valid keyframe slot other than 0.
2. Its depth cloud: P pixels drawn among those with depth, back-projected
   through the pinhole (x right, y up, the camera looking down -z).
3. Every field's sphere against every segment from the camera to a cloud
   point, all at once, (N_cap, P): a segment hits a sphere when the point of
   the segment closest to the centre lies within the radius.
4. A field is eligible when it is active and at least R segments hit it.
5. F eligible fields without replacement, by Gumbel top-k over equal
   weights; slots past the number eligible are invalid.
6. Each chosen field's R rays drawn uniformly among the cloud points whose
   segment hits it, by the inverse CDF of the ray uniforms; an invalid
   slot's among all cloud points.
7. Each ray's near and far distances (the centre's distance along the ray,
   less and plus the radius), its ground-truth distance along the ray from
   the pixel's depth, and its masks.

Where it departs from the reference's ``_sample_target_sv``:

- The draws are the caller's tensors (the harness's seeded ones): the
  cloud's pixel indices, a uniform per field and per ray, Gumbel noise per
  slot. The reference calls its own generator.
- No AABB pre-cull: every sphere meets every segment's test. The cull only
  drops spheres that no segment can reach, so the hits are the same.
- Fixed shapes: F slots always, the ones past the eligible fields invalid
  (their rays are still drawn, over the whole cloud); the reference trains
  on fewer fields instead.
- A ray's uniform u takes hit number floor(u * n) of its field's n hits,
  u * n rounded to float32 as the program rounds it. Where that product
  rounds up to n, the program (and JAX) clip to the cloud's last point,
  which may be no hit; this does the same.
- Dot products are sums over x, y, z of elementwise products in float32,
  the plain formula, so a point that lies within a rounding of a sphere
  falls on the side the program's test puts it; :func:`draw_targets`
  counts the chosen fields' pairs that lie that close (``boundary_pairs``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

BOUNDARY = 1e-6  # relative distance to a sphere's surface that one rounding can cross


class Pinhole(NamedTuple):
    """Intrinsics in pixel indices: pixel (row i, column j) looks along
    ((j - cx) / fx, -(i - cy) / fy, -1) in the camera's frame."""

    fx: float
    fy: float
    cx: float
    cy: float


class Targets(NamedTuple):
    """One iteration's draw. F slots of R rays."""

    ijs: torch.Tensor  # (F, R, 2) pixel (row, column)
    field_ids: torch.Tensor  # (F,) chosen field, meaningful where valid
    field_valid: torch.Tensor  # (F,)
    near: torch.Tensor  # (F, R)
    far: torch.Tensor  # (F, R)
    gt_distances: torch.Tensor  # (F, R) 0 where the pixel has no depth
    rgbds: torch.Tensor  # (F, R, 4)
    depth_mask: torch.Tensor  # (F, R) the surface lies before the far end, valid slots only
    term_mask: torch.Tensor  # (F, R) valid slots
    eligible: torch.Tensor  # (N_cap,)
    boundary_pairs: int  # chosen fields' (field, point) pairs within BOUNDARY of a surface


@contextlib.contextmanager
def full_float32():
    """float32 matrix products at full precision: TF32 off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def choose_view(cache_valid: torch.Tensor, slot_gumbel: torch.Tensor, iteration: int) -> int:
    """The keyframe-cache slot that iteration ``iteration`` of a frame trains
    on: the current frame (slot 0) on odd iterations if it is valid, else
    the valid slot other than 0 with the largest Gumbel noise (the first of
    equals); slot 0 where no other slot is valid."""
    valid = cache_valid.tolist()
    if iteration % 2 == 1 and valid[0]:
        return 0
    noise = slot_gumbel.tolist()
    best = 0
    for s in range(1, len(valid)):
        if valid[s] and (best == 0 or noise[s] > noise[best]):
            best = s
    return best


def view_of(cache_rgb: torch.Tensor, cache_depth: torch.Tensor, cache_c2w: torch.Tensor, slot: int):
    """Slot ``slot`` of the keyframe cache -> (RGB-D (H, W, 4) float32, c2w)."""
    rgbd = torch.cat([cache_rgb[slot].to(torch.float32), cache_depth[slot][..., None]], dim=-1)
    return rgbd, cache_c2w[slot]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def draw_targets(
    rgbd: torch.Tensor,  # (H, W, 4) the view
    c2w: torch.Tensor,  # (4, 4) the view's camera to world
    centres: torch.Tensor,  # (N_cap, 3) field centres, world frame
    active: torch.Tensor,  # (N_cap,) fields that may be drawn
    radius: float,
    num_fields: int,
    num_rays: int,
    camera: Pinhole,
    cloud_idx: torch.Tensor,  # (P,) flat pixel indices of the cloud
    u_fields: torch.Tensor,  # (N_cap,) uniforms, one a field
    u_rays: torch.Tensor,  # (F, R) uniforms, one a ray
) -> Targets:
    """Steps 2-7 of one iteration on the view ``rgbd`` (see the module)."""
    with full_float32():
        dev = rgbd.device
        w = rgbd.shape[1]
        fx, fy, cx, cy = camera

        # 2. the cloud in the camera's frame
        rows = torch.div(cloud_idx, w, rounding_mode="floor")
        cols = cloud_idx - rows * w
        z = rgbd[rows, cols, 3]
        point_ok = z != 0.0
        x = (cols.to(torch.float32) - cx) * z / fx
        y = (rows.to(torch.float32) - cy) * z / fy
        points = torch.stack([x, -y, -z], dim=-1)  # (P, 3)

        # 3. every sphere against every segment camera -> point
        rot, trans = c2w[:3, :3], c2w[:3, 3]
        centres_c = (centres - trans) @ rot  # R^T (c - t), row by row
        length2 = _dot(points, points)  # (P,)
        along = _dot(centres_c[:, None, :], points[None, :, :])  # (N_cap, P)
        t = torch.where(length2 > 0.0, along / torch.where(length2 > 0.0, length2, 1.0), 0.0).clamp(0.0, 1.0)
        gap = centres_c[:, None, :] - points[None, :, :] * t[..., None]
        dist2 = _dot(gap, gap)
        r2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2  # the radius in float32, squared
        hits = (dist2 <= r2) & point_ok[None, :]

        # 4. eligibility
        eligible = active & (hits.sum(-1) >= num_rays)

        # 5. Gumbel top-k over equal weights
        keys = -torch.log(-torch.log(u_fields.clamp(min=torch.finfo(torch.float32).tiny)))
        keys = torch.where(eligible, keys, -torch.inf)
        order = torch.sort(keys, descending=True, stable=True).indices
        n_eligible = int(eligible.sum())
        field_ids = order[:num_fields].clone()
        field_valid = torch.arange(num_fields, device=dev) < n_eligible
        field_ids[~field_valid] = 0

        # 6. rays by inverse CDF over each slot's hits
        p = points.shape[0]
        segments = torch.empty((num_fields, num_rays), dtype=torch.int64, device=dev)
        boundary = 0
        for k in range(num_fields):
            if bool(field_valid[k]):
                fid = int(field_ids[k])
                among = torch.nonzero(hits[fid]).flatten()
                near_surface = (dist2[fid] - r2).abs() <= BOUNDARY * r2
                boundary += int((near_surface & point_ok).sum())
            else:
                among = torch.arange(p, device=dev)
            n = among.numel()
            pick = torch.floor(u_rays[k] * float(n)).to(torch.int64)
            segments[k] = torch.where(pick < n, among[pick.clamp(max=n - 1)], p - 1)

        # 7. distances and masks
        ti, tj = rows[segments], cols[segments]  # (F, R)
        ijs = torch.stack([ti, tj], dim=-1)
        dx = (tj.to(torch.float32) - cx) / fx
        dy = (ti.to(torch.float32) - cy) / fy
        ray = torch.stack([dx, -dy, -torch.ones_like(dx)], dim=-1)
        ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
        centre_along = _dot(centres_c[field_ids][:, None, :], ray)
        near = centre_along - radius
        far = centre_along + radius
        rgbds = rgbd[ti, tj]
        gt = rgbds[..., 3] * torch.sqrt(dx * dx + dy * dy + 1.0)
        valid = field_valid[:, None]
        return Targets(
            ijs=ijs, field_ids=field_ids, field_valid=field_valid, near=near, far=far, gt_distances=gt,
            rgbds=rgbds, depth_mask=(gt < far) & valid, term_mask=valid.expand(num_fields, num_rays),
            eligible=eligible, boundary_pairs=boundary,
        )
