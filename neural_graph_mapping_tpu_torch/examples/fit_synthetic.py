"""End-to-end drive of the public API: fit one neural field to an analytic
sphere seen by a pinhole camera (port of examples/fit_synthetic.py).

    python -m neural_graph_mapping_tpu_torch.examples.fit_synthetic [ITERS] [--device cpu]

Each step draws 1024 pixels and 24 stratified samples a ray
(``Camera.sample_ijs_uniform``), evaluates the field set feature-major
(``apply_vmap_fm``: the fused encode, kernels ``encode_fwd`` /
``encode_bwd_table`` on the card), composites (``quadrature``), takes the
photometric, depth, free-space and TSDF losses, and steps the port's
per-field Adam (``mapping/optimizer.py`` with no weight decay: optax's
``adam(1e-3, eps=1e-15)``). Then it renders the full image, reports depth
and colour errors, and checks the tiled KNN route (``apply_knn_tiled``,
kernels ``topk2_fields`` and the MoE encode on the card) against the
field-parallel one. Runs on the card unless ``--device cpu`` is given; the
draws come from one seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import time

import torch

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.mapping import optimizer
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import losses, quadrature

RAYS, SAMPLES, TRUNC = 1024, 24, 0.1
SPHERE_CENTER = (0.0, 0.0, -2.0)
SPHERE_RADIUS = 0.5
NEAR, FAR = 1.0, 3.0


def make_camera() -> Camera:
    return Camera.create(width=80, height=60, fx=70.0, fy=70.0, cx=40.0, cy=30.0)


def make_field_set() -> NeuralFieldSet:
    return NeuralFieldSet(
        dim_points=3,
        field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=dict(
            encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
            encoding_kwargs=dict(
                pos_dim=3, log2_hashmap_size=12, nr_levels=16, nr_feat_per_level=2,
                coarsest_scale=1.0, finest_scale=1e-4, init_scale=1e-5,
            ),
            num_layers=1, dim_out=4,
        ),
        num_knn=2, distance_factor=10.0, outside_value=1.0,
        field_radius=1.0, scale_mode="unit_cube",
    )


def gt_ray(cam: Camera, ijs: torch.Tensor):
    """Ground truth of the sphere scene along the rays through ``ijs``:
    distance (0 off the sphere), colour (the shaded normal) and hit mask."""
    dirs = cam.ijs_to_directions(ijs, "opengl")
    center = torch.tensor(SPHERE_CENTER, device=ijs.device)
    oc = -center
    b = torch.sum(dirs * oc, dim=-1)
    c = torch.sum(oc * oc) - SPHERE_RADIUS**2
    disc = b * b - c
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where(hit & (t > 0), t, 0.0)
    normal = (dirs * t[..., None] - center) / SPHERE_RADIUS
    color = torch.where(hit[..., None], 0.5 + 0.5 * normal, 0.0)
    return t, color, hit


def evaluate(fset, params, pts, positions, orientations) -> torch.Tensor:
    """(R, S, 3) points -> (R, S, 4) field outputs, feature-major inside."""
    r, s = pts.shape[:2]
    out = fset.apply_vmap_fm(params, pts.reshape(1, -1, 3), positions, orientations)  # (1, 4, R*S)
    return out[0].transpose(0, 1).reshape(r, s, 4)


def ray_losses(fset, params, cam, ijs, u, positions, orientations):
    """The step's loss on rays through ``ijs`` with stratified draws ``u``
    (R, S) -> (loss, photometric, depth)."""
    gt_dist, gt_color, hit = gt_ray(cam, ijs)
    n = ijs.shape[0]
    near = torch.full((n,), NEAR, device=ijs.device)
    far = torch.full((n,), FAR, device=ijs.device)
    pts, dists = cam.sample_ijs_uniform(ijs, u.shape[-1], near, far, u=u)
    outs = evaluate(fset, params, pts, positions, orientations)
    q = quadrature.quadrature(
        "nrgbd", outs[..., :3], outs[..., 3], dists, -pts[..., 2], geometry_factor=20.0,
    )
    l_ph = losses.photometric_loss("l1", gt_color, q.colors, mask=hit)
    l_d = losses.depth_loss("huber", gt_dist, q.depths, mask=hit)
    fs_mask = (dists < (gt_dist[:, None] - TRUNC)) & hit[:, None]
    l_fs = losses.freespace_loss(outs[..., 3], TRUNC, fs_mask)
    deltas = gt_dist[:, None] - dists
    ts_mask = (torch.abs(deltas) < TRUNC) & hit[:, None]
    l_ts = losses.tsdf_loss(outs[..., 3], deltas, TRUNC, ts_mask)
    return l_ph + l_d + 40.0 * l_fs + 50.0 * l_ts, l_ph, l_d


def main(iters: int = 300, device: str = "cuda", log_every: int = 100) -> dict:
    """Fit, render and check -> the run's numbers (losses every step)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    cam = make_camera()
    fset = make_field_set()
    gen = torch.Generator(dev).manual_seed(0)
    params = fset.init_fields(1, gen, dev)
    positions = torch.tensor([SPHERE_CENTER], device=dev)
    orientations = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    adam_cfg = optimizer.AdamConfig(learning_rate=1e-3, eps=1e-15, weight_decay=0.0)
    state = optimizer.init_adam_state(params)
    ids = torch.zeros((1,), dtype=torch.int64, device=dev)
    valid = torch.ones((1,), dtype=torch.bool, device=dev)
    scale = torch.tensor([cam.height - 1, cam.width - 1], dtype=torch.float32, device=dev)

    history = []
    t0 = time.perf_counter()
    for i in range(iters + 1):
        ijs = torch.rand((RAYS, 2), generator=gen, device=dev) * scale
        u = torch.rand((RAYS, SAMPLES), generator=gen, device=dev)
        sub = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, l_ph, l_d = ray_losses(fset, sub, cam, ijs, u, positions, orientations)
        grads = dict(zip(sub, torch.autograd.grad(loss, list(sub.values()))))
        params, state = optimizer.adam_slice_update(adam_cfg, params, state, ids, valid, grads, sub)
        history.append(loss.detach())
        if log_every and i % log_every == 0:
            print(f"iter {i:4d}  loss {loss.item():.4f}  photo {l_ph.item():.4f}  depth {l_d.item():.5f}")
    history = [float(x) for x in history]  # waits for the device
    seconds = time.perf_counter() - t0
    print(f"{iters} iters in {seconds:.1f}s  ({iters * RAYS / seconds:,.0f} rays/s)")

    with torch.no_grad():
        ijs = cam._full_ijs(dev).to(torch.float32)
        gt_dist, gt_color, hit = gt_ray(cam, ijs)
        n = ijs.shape[0]
        pts, dists = cam.sample_ijs_uniform(
            ijs, 64, torch.full((n,), NEAR, device=dev), torch.full((n,), FAR, device=dev), generator=gen
        )
        outs = evaluate(fset, params, pts, positions, orientations)
        q = quadrature.quadrature(
            "nrgbd", outs[..., :3], outs[..., 3], dists, -pts[..., 2], geometry_factor=20.0
        )
        depth_err = torch.abs(q.depths - cam.distance_to_depth(gt_dist, ijs))
        depth_l1_cm = float(losses.masked_mean(depth_err, hit)) * 100
        color_l1 = float(losses.masked_mean(torch.abs(q.colors - gt_color), hit[:, None]))
        term_prob = float(losses.masked_mean(q.term_probs, hit))
        print(f"depth L1 on surface: {depth_l1_cm:.2f} cm")
        print(f"color L1 on surface: {color_l1:.3f}")
        print(f"term prob on surface: {term_prob:.3f}")

        sel = torch.arange(0, n, 13, device=dev)
        pts_sel = pts[sel].reshape(-1, 3)
        # the tiled MoE route evaluates every routed pair (no capacity drops)
        knn_out = fset.apply_knn_tiled(params, pts_sel, positions, orientations, valid)
        inside = torch.linalg.vector_norm(pts_sel - positions[0], dim=-1) < 1.0
        diff = torch.abs(knn_out - outs[sel].reshape(-1, 4)).amax(dim=-1)
        knn_diff = float(torch.where(inside, diff, 0.0).max())
        print("knn-vs-vmap max diff (inside pts):", knn_diff)
    return {
        "losses": history, "seconds": seconds, "rays_per_s": iters * RAYS / seconds,
        "depth_l1_cm": depth_l1_cm, "color_l1": color_l1, "term_prob": term_prob,
        "knn_vs_vmap_max_diff": knn_diff, "knn_points_inside": int(inside.sum()),
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("iters", nargs="?", type=int, default=300)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.iters, args.device)
