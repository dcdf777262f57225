"""Field-count scale sweep of the port (port of benchmarks/scale_sweep.py).

A map of a thousand or more fields is what a long room-scale run reaches;
a short run allocates about a hundred. This grows a warm map to N fields
(N in {128, 512, 2048} by default) and times what could fall off a cliff
as N grows: the training frame, which gathers and scatters per-field rows
over the whole capacity (the active workload, 32 fields x 512 rays x
(8 + 16) samples, stays constant by design), and one 640x480 render, whose
``topk2_fields`` routes every sample over all N centres and whose tiled
dispatch sorts every routed pair.

Per N: build the warm map (:func:`build_engine`, the 320x240 synthetic
scene of 20 frames at the workload below), grow it (:func:`grow_to`), time
10 training frames twice and keep the better pass (:func:`time_train`; the
draws are made before the clock starts), then one 640x480 render at span
512 in blocks of 8,192 rays (:func:`time_render_block`).

Usage:
    python -m neural_graph_mapping_tpu_torch.scripts.scale_sweep [N ...] [--device cpu]

Prints one JSON line per N (training rays/s, ms a render block, s a
640x480 image, fields, capacity), then the card's name and power limit
(``nvidia-smi``). Runs on the card unless ``--device cpu`` is given, and
raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, map_state, optimizer, sampling

DEFAULT_SIZES = (128, 512, 2048)
SENSOR_RATE_RAYS_PER_S = 2_457_600.0  # 5 iterations x 16,384 rays x 30 fps
TRAIN_FRAMES = 10
DRAW_SEED = 11
NEW_OBSERVED = 8  # new fields marked observed, so selection mixes old and new
FIELD_SAMPLES = 20  # sphere samples of sampling.sample_target_mv's visibility test

# the warm map: bench.py's scene and workload (the reference's constants:
# 32 fields x 512 rays x (8 + 16) samples, L = 16, T = 2^12, 2 features)
SCENE = {"num_frames": 20, "width": 320, "height": 240, "fx": 280.0, "fy": 280.0, "orbit_radius": 2.5}
WORKLOAD = {
    "model_kwargs": {
        "dim_points": 3,
        "field_type": "neural_graph_mapping_tpu.models.fields.NeuralField",
        "field_kwargs": {
            "encoding_type": "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
            "encoding_kwargs": {
                "pos_dim": 3, "log2_hashmap_size": 12, "nr_levels": 16,
                "nr_feat_per_level": 2, "coarsest_scale": 1.0,
                "finest_scale": 1e-4, "init_scale": 1e-5,
            },
            "num_layers": 1, "dim_out": 4,
        },
        "num_knn": 2, "distance_factor": 10.0, "field_radius": 1.0,
        "scale_mode": "unit_cube", "outside_value": 1.0,
    },
    "field_radius": 1.0,
    "num_train_fields": 32,
    "num_rays_per_field": 512,
    "num_samples_coarse": 8,
    "num_samples_depth_guided": 16,
    "num_iterations_per_frame": 5,
    "num_kf_slots": 256,
    "max_new_fields": 256,
    "geometry_mode": "nrgbd",
    "geometry_factor": 20.0,
    "truncation_distance": 0.1,
    "learning_rate": 1e-3,
    "adam_eps": 1e-15,
    "adam_weight_decay": 1e-5,
}
RENDER_CAMERA = {"width": 640, "height": 480, "fx": 554.256, "fy": 554.256, "cx": 320.0, "cy": 240.0}
RENDER_FRAME = 5
RENDER_BLOCK = 8192
RENDER_SPAN = 512


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_engine(device="cuda"):
    """The warm map: every frame of the scene through ``process_frame`` ->
    (dataset, map)."""
    ds = SyntheticDataset(SCENE)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(WORKLOAD, device=device)
    for fid in range(len(ds)):
        ngm.process_frame(ds, fid, ds[fid]["rgbd"])
    return ds, ngm


def grow_to(ngm, n_target: int, generator=None, positions=None, fresh=None) -> None:
    """Allocate fields up to ``n_target``, the state a long run reaches:
    positions uniform in the map's bounding box widened by 1 m (or
    ``positions``, (n_target - num_fields, 3)), identity orientations,
    anchor frame 0, 100 training iterations, fresh params from
    ``init_fields`` at the grown capacity (or ``fresh``), zero Adam state;
    the capacity doubles as the map's does, the observed mask is padded to
    it and the first NEW_OBSERVED new fields are marked observed.
    ``generator``: the draws' generator on the map's device."""
    n_now = ngm.num_fields
    n_new = n_target - n_now
    if n_new < 0:
        raise ValueError(f"the map already has {n_now} fields, more than {n_target}")
    if n_new == 0:
        return
    dev = ngm._device
    if positions is None:
        pos = ngm._map_arrays.positions[:n_now]
        lo, hi = pos.amin(0) - 1.0, pos.amax(0) + 1.0
        positions = lo + (hi - lo) * torch.rand((n_new, 3), generator=generator, device=dev)
    while ngm.capacity < n_target:
        ngm._map_arrays = map_state.grow_capacity(ngm._map_arrays, ngm.capacity * 2)
        ngm._params = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in ngm._params.items()}
    cap = ngm.capacity
    if fresh is None:
        fresh = ngm._fset.init_fields(cap, generator, dev)
    rows = torch.arange(cap, device=dev)
    new = (rows >= n_now) & (rows < n_target)
    ngm._params = {k: torch.where(new.reshape((-1,) + (1,) * (v.dim() - 1)), fresh[k].to(v), v)
                   for k, v in ngm._params.items()}
    ma = ngm._map_arrays
    leaves = {name: getattr(ma, name).clone() for name in ("positions", "orientations", "kf_ids",
                                                          "training_iterations")}
    leaves["positions"][n_now:n_target] = positions.to(leaves["positions"])
    leaves["orientations"][n_now:n_target] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    leaves["kf_ids"][n_now:n_target] = 0
    leaves["training_iterations"][n_now:n_target] = 100
    ngm._map_arrays = ma._replace(**leaves)
    ngm._num_fields = n_target
    ngm._adam = optimizer.init_adam_state(ngm._params)
    observed = torch.zeros((cap,), dtype=torch.bool, device=dev)
    observed[: ngm._observed_mask.shape[0]] = ngm._observed_mask
    ngm._observed_mask = observed | ((rows >= n_now) & (rows < n_now + NEW_OBSERVED))


def iteration_draws(shapes: engine.DrawShapes, generator) -> engine.IterationDraws:
    """One multi-view iteration's draws, made ahead of time on the
    generator's device."""
    dev = generator.device
    f, r = shapes.num_train_fields, shapes.num_rays
    return engine.IterationDraws(
        u_obs=torch.rand((shapes.capacity,), generator=generator, device=dev),
        u_rand=torch.rand((shapes.capacity,), generator=generator, device=dev),
        offsets=torch.randn((FIELD_SAMPLES, 3), generator=generator, device=dev),
        kf_gumbel=sampling.gumbel_noise((f, r, shapes.num_slots), generator, dev),
        pix_u=torch.rand((f, r, 2), generator=generator, device=dev),
        u_coarse=torch.rand((f, r, shapes.num_coarse), generator=generator, device=dev),
        u_guided=torch.rand((f, r, shapes.num_guided), generator=generator, device=dev),
    )


def time_train(ngm, frames: int = TRAIN_FRAMES, generator=None) -> float:
    """``frames`` training frames (each the frame step's iterations on the
    map's observed mask), a warm-up frame, then two timed passes -> the
    better pass's training rays/s. The map keeps the trained state."""
    generator = generator or torch.Generator(ngm._device).manual_seed(DRAW_SEED)
    iters = ngm._num_iterations_per_frame
    shapes = ngm._draw_shapes()
    draws = [[iteration_draws(shapes, generator) for _ in range(iters)] for _ in range(2 * frames + 1)]
    allocated = ngm._allocated_mask()

    def one_frame(params, adam, ti, frame_draws):
        return engine.optimization_iterations_scan(
            ngm._fset, ngm._camera, ngm._rcfg, ngm._ocfg, ngm._loss_cfg, ngm._num_train_fields, iters,
            params, adam, ti, ngm._map_arrays.positions, ngm._map_arrays.orientations, allocated,
            ngm._observed_mask, ngm._cache_rgb, ngm._cache_depth, ngm._cache_c2w_dev, ngm._cache_valid_dev,
            iteration_draws=frame_draws,
        )[:3]

    params, adam, ti = one_frame(ngm._params, ngm._adam, ngm._map_arrays.training_iterations, draws[-1])
    _sync(ngm._device)
    best = float("inf")
    for p in range(2):
        t0 = time.perf_counter()
        for i in range(frames):
            params, adam, ti = one_frame(params, adam, ti, draws[p * frames + i])
        _sync(ngm._device)
        best = min(best, time.perf_counter() - t0)
    ngm._params, ngm._adam = params, adam
    ngm._map_arrays = ngm._map_arrays._replace(training_iterations=ti)
    return frames * iters * ngm._num_train_fields * ngm._loss_cfg.num_rays_per_field / best


def render_camera() -> Camera:
    return Camera.create(**RENDER_CAMERA)


def time_render_block(ngm, ds, block: int = None, span: int = None):
    """One 640x480 render of frame RENDER_FRAME's pose after a warm-up ->
    (ms a block, s the image); ``block`` rays a block (RENDER_BLOCK), at
    ``span`` samples a ray (RENDER_SPAN)."""
    block, span = block or RENDER_BLOCK, span or RENDER_SPAN
    camera = render_camera()
    ngm._eval_span_samples = span
    ngm._eval_num_samples = span
    ngm._pixel_block_size = block
    c2w = ds[RENDER_FRAME]["c2w"]
    n_blocks = -(-camera.width * camera.height // block)
    ngm.render_image(c2w, camera)
    _sync(ngm._device)
    t0 = time.perf_counter()
    rgbd, _ = ngm.render_image(c2w, camera)
    _sync(ngm._device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(rgbd).all()):
        raise RuntimeError(f"the render of the {ngm.num_fields}-field map is not finite")
    return dt / n_blocks * 1e3, dt


def sweep_one(n: int, device="cuda"):
    """The sweep at ``n`` fields -> (result, dataset, map); result None where
    the warm map already has more than ``n`` fields."""
    ds, ngm = build_engine(device)
    if ngm.num_fields > n:
        return None, ds, ngm
    grow_to(ngm, n, torch.Generator(ngm._device).manual_seed(n))
    rays = time_train(ngm)
    ms_block, image_s = time_render_block(ngm, ds)
    result = {"n": n, "fields": ngm.num_fields, "capacity": ngm.capacity, "train_rays_per_s": rays,
              "vs_sensor_rate": rays / SENSOR_RATE_RAYS_PER_S, "render_ms_per_block": ms_block,
              "render_s_per_640x480": image_s}
    return result, ds, ngm


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int, default=list(DEFAULT_SIZES), metavar="N")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    for n in args.sizes:
        result, _, ngm = sweep_one(n, args.device)
        if result is None:
            result = {"n": n, "skipped": f"the warm map already has {ngm.num_fields} fields"}
        print(json.dumps(result), flush=True)
        del ngm
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
