#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neural_graph_mapping_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; TF32 off.
2. build: compiles every ``csrc/*.cu`` for sm_90a into
   ``neural_graph_mapping_tpu_torch/_build/`` (one nvcc per source, all
   started together) and prints the build seconds.
3. kernels (training): each training kernel against its plain PyTorch
   version on the card, at the training path's shapes, with the stated
   tolerance; median times of 20 runs (CUDA events) after warm-up.
4. slice: the port's ``NeuralGraphMap.process_frame`` over 12 frames of the
   synthetic scene (160x120) at the production configuration
   (config/neural_graph_map.yaml + config/synthetic.yaml, written out below);
   checks fields, finite losses, training counts and that every training
   kernel launched once per optimization iteration; then one optimization
   iteration at the same width on the card against the same iteration on
   the CPU (plain versions), same weights and draws.
5. kernels (render): the three render kernels against their plain versions
   at the shapes of one production render block of the trained map (8192
   rays x 512 samples x k = 2 = 8,388,608 pairs): ``topk2_fields`` exact on
   all 4,194,304 points, the two MoE encodes within 1e-5 on 256 live tiles
   (tables U(-1, 1)); medians of 20 timed runs.
6. render: ``NeuralGraphMap.render_image`` of frame 11's pose on the trained
   map at 160x120 (PSNR and depth-L1 against the frame, median ms of 5
   renders, each render kernel launched once per block) and at 640x480
   (ms per image, rays/s, samples/s).
7. render_carried: one 160x120 render at ``eval_span_samples: 768`` (k * S
   not a power of two): ``encode_fwd_moe`` once per block, the ray kernel
   never.
8. render_vs_cpu: one 512-ray block at 512 samples on the card and on the
   CPU (plain versions), same state and jitter, max abs <= 1e-4; the card's
   block runs under ``torch.cuda.set_sync_debug_mode("error")``, so a host
   sync inside it fails the run.

    python3 chip_smoke.py --profile PATH

adds a phase after the slice: a fresh map runs the same 12 frames with
torch.profiler over frames 7-12 and prints the device kernel count, the
device-busy time and the largest device items; PATH gets the full
``key_averages()`` table. It also profiles one 160x120 render of the
trained map (PATH with ``.render`` added). The timed phases never run under
the profiler.

The line before the last is a JSON summary of the six kernels (launches
from the path that runs each: training kernels from the 12 frames, the
render kernels from one render of their route); the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

NUM_FRAMES = 12
STEADY_FROM = 5  # frames 6..12 (1-based) are timed as the steady state
RENDER_FRAME = 11

# Least-time bounds (H100 SXM data sheet): bytes
# over the memory rate, operations over the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of one point at one lattice level, counted from csrc/permuto.cu
# lattice_level + encode_point: 74 f32 (scale/shift/elevate 18, round and
# remainders 20, barycentric 18, blend 16, sums 2) and 54 integer (ranks 12,
# fix-up 12, hashes of 4 corners 30).
LATTICE_OPS = 128

# config/neural_graph_map.yaml merged with config/synthetic.yaml, written out
# so the run needs no YAML parser; tests/test_torch_engine.py checks that it
# equals what the port's loader gives for those files.
CONFIG = {
    "model_type": "neural_graph_mapping_tpu.models.fields.NeuralFieldSet",
    "model_kwargs": {
        "dim_points": 3,
        "field_type": "neural_graph_mapping_tpu.models.fields.NeuralField",
        "field_kwargs": {
            "encoding_type": "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
            "encoding_kwargs": {
                "pos_dim": 3,
                "log2_hashmap_size": 12,
                "nr_levels": 16,
                "nr_feat_per_level": 2,
                "coarsest_scale": 1,
                "finest_scale": 0.0001,
                "init_scale": 1e-05,
            },
            "num_layers": 1,
            "dim_out": 4,
            "dim_mlp_out": None,
            "skip_mode": "no",
            "initial_geometry_bias": 0.0,
            "neus_initial_sd": 1.0,
        },
        "num_knn": 2,
        "distance_factor": 10.0,
        "field_radius": 1.0,
        "scale_mode": "unit_cube",
        "outside_value": 1.0,
    },
    "color_factor": 1.0,
    "geometry_factor": 20.0,
    "learning_rate": 0.001,
    "field_radius": 1.0,
    "termination_weight": 0.0,
    "photometric_weight": 1.0,
    "photometric_loss": "l1",
    "depth_weight": 1.0,
    "depth_loss": "huber",
    "freespace_weight": 40.0,
    "tsdf_weight": 50.0,
    "near_distance": 0.0,
    "far_distance": 8.0,
    "pixel_block_size": 8192,
    "host_prefetch_depth": 2,
    "log_iteration_freq": 100,
    "num_iterations_per_frame": 5,
    "geometry_mode": "nrgbd",
    "truncation_distance": 0.1,
    "disable_relative_fields": False,
    "loglevel": 20,
    "num_train_fields": 32,
    "num_rays_per_field": 512,
    "num_samples_coarse": 8,
    "num_samples_depth_guided": 16,
    "range_depth_guided": None,
    "adam_eps": 1e-15,
    "adam_weight_decay": 1e-05,
    "update_mode": "multi_view",
    "num_kf_slots": 1000,
    "max_new_fields": 256,
    "max_depth": None,
    "seed": 0,
    "benchmark": False,
    "single_field_id": None,
    "block_size": 262144,
    "preview_res_factor": 0.3,
    "render_vis": False,
    "render_frames": [],
    "render_frame_freq": 200,
    "extract_mesh_frame_freq": 100,
    "extract_mesh_frames": [],
    "extract_mesh_fields": [],
    "rerun_vis": False,
    "rerun_save": None,
    "rerun_connect_addr": None,
    "dataset_type": "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset",
    "dataset_config": {"num_frames": 60, "width": 160, "height": 120, "fx": 140.0, "fy": 140.0},
    "eval_ratio": 0.1,
    "eval_chunk_freq": 5,
    "eval_metrics": ["psnr", "depthl1"],
    "extract_mesh": True,
    "mesh_resolution": 0.04,
}


def phase(phase_name: str, **fields) -> None:
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def time_ms(torch, fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for work that moves n_bytes and does n_ops."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels(torch, permuto_cuda, enc):
    """Phase 3: every training kernel against its plain version at the
    path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    b, p = 32, 512 * 24  # 32 fields x 512 rays x (8 + 16) samples
    n_levels, t = enc.nr_levels, enc.capacity
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    # tables U(-1, 1) (not the 1e-5 init) so the comparison means something;
    # field-local unit-cube coordinates around [0, 1]
    table = torch.rand((b, 2, n_levels, t), generator=gen, device=dev) * 2 - 1
    coords = torch.rand((b, 3, p), generator=gen, device=dev) * 1.5 - 0.25
    g = torch.randn((b, 2 * n_levels, p), generator=gen, device=dev)
    slots, hw, m = 1000, 160 * 120, 32 * 20
    values = torch.rand((slots, hw), generator=gen, device=dev) * 8.0
    idx = torch.randint(0, hw, (slots, m), generator=gen, device=dev)

    f32 = 4
    enc_bytes = (table.numel() + coords.numel() + b * 2 * n_levels * p) * f32
    enc_ops = b * p * n_levels * LATTICE_OPS
    bounds = {
        # table, coords in; features out
        "encode_fwd": bound(enc_bytes, enc_ops),
        # coords, g in; table gradient out (the same byte count)
        "encode_bwd_table": bound(enc_bytes, enc_ops + b * p * n_levels * 16),
        # per lookup: an 8-byte index and the 4-byte value it needs in, 4 out
        "batched_gather": bound(idx.numel() * (8 + 4 + 4), 0),
    }
    library = {"batched_gather": time_ms(torch, lambda: torch.gather(values, 1, idx))}

    rows = []
    out = permuto_cuda.encode_fwd(table, coords, *consts)
    ref = permuto_cuda.encode_fwd_plain(table, coords, *consts)
    err = (out - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"encode_fwd max abs err {err} > 1e-5")
    rows.append(("encode_fwd", err, "max abs <= 1e-5",
                 time_ms(torch, lambda: permuto_cuda.encode_fwd(table, coords, *consts)),
                 time_ms(torch, lambda: permuto_cuda.encode_fwd_plain(table, coords, *consts))))

    out = permuto_cuda.encode_bwd_table(coords, g, *consts)
    ref = permuto_cuda.encode_bwd_table_plain(coords, g, *consts, t)
    err = (out - ref).abs().max().item()
    limit = 1e-4 * ref.abs().max().item()
    if not err <= limit:
        raise AssertionError(f"encode_bwd_table max abs err {err} > {limit}")
    rows.append(("encode_bwd_table", err, "max abs <= 1e-4 * max|plain|",
                 time_ms(torch, lambda: permuto_cuda.encode_bwd_table(coords, g, *consts)),
                 time_ms(torch, lambda: permuto_cuda.encode_bwd_table_plain(coords, g, *consts, t))))

    out = permuto_cuda.batched_gather(values, idx)
    ref = permuto_cuda.batched_gather_plain(values, idx)
    if not torch.equal(out, ref):
        raise AssertionError("batched_gather differs from torch.gather")
    rows.append(("batched_gather", (out - ref).abs().max().item(), "exact",
                 time_ms(torch, lambda: permuto_cuda.batched_gather(values, idx)),
                 time_ms(torch, lambda: permuto_cuda.batched_gather_plain(values, idx))))
    shapes = {"encode_fwd": [b, p], "encode_bwd_table": [b, p], "batched_gather": [slots, hw, m]}
    return report_rows(rows, shapes, bounds, library)


def report_rows(rows, shapes, bounds, library):
    """Print one kernel phase line per row; -> {name: measurements}."""
    out = {}
    for name, err, tol, ms, plain_ms in rows:
        bound_ms, bound_by = bounds[name]
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library.get(name))
        phase("kernel", name=name, tolerance=tol, shape=shapes[name], **row)
        out[name] = row
    return out


def to_cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to_cpu(v) for v in x)
    return x


def clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    if isinstance(x, tuple):
        return tuple(clone(v) for v in x)
    return x


def check_iteration_against_cpu(torch, engine, ngm):
    """One optimization iteration at production width on the card and on
    the CPU (plain versions), from the same state and the same draws."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(99)
    n = ngm.capacity
    f, r = ngm._num_train_fields, ngm._loss_cfg.num_rays_per_field
    s = ngm._num_kf_slots
    rc = ngm._rcfg
    draws = engine.IterationDraws(
        u_obs=torch.rand((n,), generator=gen, device=dev),
        u_rand=torch.rand((n,), generator=gen, device=dev),
        offsets=torch.randn((20, 3), generator=gen, device=dev),
        kf_gumbel=-torch.log(-torch.log(torch.rand((f, r, s), generator=gen, device=dev).clamp_min(1e-30))),
        pix_u=torch.rand((f, r, 2), generator=gen, device=dev),
        u_coarse=torch.rand((f, r, rc.num_samples_coarse), generator=gen, device=dev),
        u_guided=torch.rand((f, r, rc.num_samples_depth_guided), generator=gen, device=dev),
    )
    state = (
        ngm._params, ngm._adam, ngm._map_arrays.training_iterations,
        ngm._map_arrays.positions, ngm._map_arrays.orientations, ngm._allocated_mask(),
        ngm._observed_mask, ngm._cache_rgb, ngm._cache_depth, ngm._cache_c2w_dev,
        ngm._cache_valid_dev,
    )

    def run(fset, st, dr):
        return engine.optimization_iteration(
            fset, ngm._camera, ngm._rcfg, ngm._ocfg, ngm._loss_cfg, f, *st, draws=dr
        )[3]

    gpu = run(ngm._fset, clone(state), draws)
    cpu_fset = copy.deepcopy(ngm._fset).to("cpu")
    cpu = run(cpu_fset, to_cpu(state), to_cpu(draws))
    worst = 0.0
    for k, v in gpu.items():
        a, b = v.item(), cpu[k].item()
        if not (math.isfinite(a) and math.isfinite(b)):
            raise AssertionError(f"non-finite loss {k}: gpu {a}, cpu {b}")
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if rel > 1e-3:
            raise AssertionError(f"loss {k}: gpu {a} vs cpu {b} (rel {rel:.2e} > 1e-3)")
    return worst, {k: v.item() for k, v in gpu.items()}


def profiled(torch, fn):
    """Run fn() under torch.profiler -> (profile, wall ms, device events,
    device-busy ms as the union of the device intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:  # union of device intervals
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    return prof, wall_ms, len(spans), busy_us / 1e3


def top_items(prof, busy_ms, out_path: pathlib.Path, n: int = 12):
    """Write the key_averages table to out_path; -> the n largest device items."""
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=200, max_name_column_width=80)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(table)
    top = sorted(averages, key=lambda a: a.self_device_time_total, reverse=True)[:n]
    return [
        {"name": a.key[:80], "ms": a.self_device_time_total / 1e3, "count": a.count,
         "share": a.self_device_time_total / 1e3 / busy_ms}
        for a in top
    ]


def profile_slice(torch, engine, ds, frames, steady_ms, out_path: pathlib.Path) -> None:
    """--profile: torch.profiler over the steady frames of a fresh map."""
    ngm = engine.NeuralGraphMap(CONFIG, device="cuda")
    for fid in range(STEADY_FROM + 1):
        ngm.process_frame(ds, fid, frames[fid])
    later = frames[STEADY_FROM + 1:]

    def run():
        for fid, rgbd in enumerate(later, start=STEADY_FROM + 1):
            ngm.process_frame(ds, fid, rgbd)

    prof, wall_ms, events, busy_ms = profiled(torch, run)
    n = len(later)
    phase(
        "profile", frames=[STEADY_FROM + 2, NUM_FRAMES], device_events=events,
        device_events_per_frame=events / n, device_busy_ms=busy_ms,
        device_busy_ms_per_frame=busy_ms / n, profiled_wall_ms=wall_ms,
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_mean=1.0 - (busy_ms / n) / steady_ms,
        top_self_device_ms=top_items(prof, busy_ms, out_path), table=str(out_path),
    )


def profile_render(torch, ngm, ds, render_ms, out_path: pathlib.Path) -> None:
    """--profile: torch.profiler over one 160x120 render of the trained map."""
    c2w = ds[RENDER_FRAME]["c2w"]
    ngm.render_image(c2w, ds.camera)
    prof, wall_ms, events, busy_ms = profiled(torch, lambda: ngm.render_image(c2w, ds.camera))
    phase(
        "profile_render", device_events=events, device_busy_ms=busy_ms, profiled_wall_ms=wall_ms,
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_median=1.0 - busy_ms / render_ms,
        top_self_device_ms=top_items(prof, busy_ms, out_path), table=str(out_path),
    )


def capture_call(module, name: str, fn):
    """Run fn() with ``module.name`` wrapped -> (args, kwargs) of its first call."""
    orig = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    if not seen:
        raise AssertionError(f"{name} was not called")
    return seen[0]


def block_call(torch, ngm, camera, c2w, offset: int, rays: int, u):
    """Positional and keyword arguments of engine.render_block_tiled for
    rays [offset, offset + rays) of the row-major pixel grid of ``camera``."""
    dev = ngm._params["w0"].device
    ii, jj = torch.meshgrid(torch.arange(camera.height, device=dev),
                            torch.arange(camera.width, device=dev), indexing="ij")
    ijs = torch.stack([ii, jj], -1).reshape(-1, 2).float()[offset : offset + rays]
    args = (ngm._fset, camera, ngm._rcfg, ngm._eval_span_samples, ngm._eval_near, ngm._eval_far,
            ngm._params, ngm._map_arrays.positions, ngm._map_arrays.orientations,
            ngm._allocated_mask(), ijs, torch.as_tensor(c2w, device=dev, dtype=torch.float32))
    return args, dict(u=u, block_offset=offset, sample_spacing=float(ngm._sample_spacing))


def check_render_kernels(torch, engine, permuto_cuda, topk, ngm, ds):
    """Phase 5: the render kernels against their plain versions at the
    shapes of the first 8192-ray block of the trained map's 160x120 render."""
    dev = ngm._params["w0"].device
    gen = torch.Generator(dev).manual_seed(4321)
    block = min(ngm.render_block_size(), ds.camera.height * ds.camera.width)
    u = torch.rand((block, ngm._eval_span_samples), generator=gen, device=dev)
    args, kw = block_call(torch, ngm, ds.camera, ds[RENDER_FRAME]["c2w"], 0, block, u)
    (pts, cen, valid), _ = capture_call(
        topk, "topk2_fields", lambda: engine.render_block_tiled(*args, use_ray_kernel=True, **kw))
    rays_args, rays_kw = capture_call(
        permuto_cuda, "encode_fwd_moe_rays",
        lambda: engine.render_block_tiled(*args, use_ray_kernel=True, **kw))
    moe_args, moe_kw = capture_call(
        permuto_cuda, "encode_fwd_moe",
        lambda: engine.render_block_tiled(*args, use_ray_kernel=False, **kw))
    f32 = 4
    rows, shapes, bounds = [], {}, {}

    # topk2_fields: bit-identical on every point
    d, i = topk.topk2_fields(pts, cen, valid)
    wd, wi = topk.topk2_fields_plain(pts, cen, valid)
    finite = torch.isfinite(wd)
    if not (torch.equal(i, wi) and torch.equal(torch.isfinite(d), finite)
            and torch.equal(d[finite], wd[finite])):
        raise AssertionError("topk2_fields differs from its plain version")
    n_pts, n_cen, n_valid = pts.shape[1], cen.shape[0], int(valid.sum())
    rows.append(("topk2_fields", 0.0, "exact (distances and indices)",
                 time_ms(torch, lambda: topk.topk2_fields(pts, cen, valid)),
                 time_ms(torch, lambda: topk.topk2_fields_plain(pts, cen, valid))))
    shapes["topk2_fields"] = {"points": n_pts, "centres": n_cen, "valid_centres": n_valid}
    # points + centres (xyz, valid) in, 2 distances + 2 indices out; 8 f32
    # operations per (point, valid centre)
    bounds["topk2_fields"] = bound(n_pts * 12 + n_cen * 13 + n_pts * 16, n_pts * n_valid * 8)

    # the MoE encodes on tables U(-1, 1), compared on 256 live tiles
    for name, (c_args, c_kw) in (("encode_fwd_moe_rays", (rays_args, rays_kw)),
                                 ("encode_fwd_moe", (moe_args, moe_kw))):
        kernel = getattr(permuto_cuda, name)
        plain = getattr(permuto_cuda, name + "_plain")
        tables = torch.rand(c_args[0].shape, generator=gen, device=dev) * 2 - 1
        c_args = (tables,) + tuple(c_args[1:])
        num_live = c_kw["num_live_tiles"]
        live = int(num_live)
        n_tiles, levels = c_args[1].shape[0], tables.shape[2]
        sel = torch.unique(torch.linspace(0, live - 1, min(256, live), device=dev).round().long())
        full = kernel(*c_args, **c_kw)
        per_tile = (1, 2, 3) if name == "encode_fwd_moe_rays" else (1, 2)  # tile-major inputs
        sub_args = tuple(a[sel].contiguous() if j in per_tile else a for j, a in enumerate(c_args))
        sub_kw = {k: v for k, v in c_kw.items() if k != "num_live_tiles"}
        ref = plain(*sub_args, **sub_kw)
        err = float((full[sel] - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{name} max abs err {err} > 1e-5 on {sel.numel()} live tiles")
        rows.append((name, err, f"max abs <= 1e-5 on {sel.numel()} live tiles",
                     time_ms(torch, lambda: kernel(*c_args, **c_kw)),
                     time_ms(torch, lambda: plain(*c_args, **c_kw))))
        te = c_args[3] if name == "encode_fwd_moe_rays" else c_args[2]
        experts = int(torch.unique(te[:live]).numel())
        pairs = live * permuto_cuda.TILE
        in_bytes = pairs * (8 if name == "encode_fwd_moe_rays" else 12)  # index + distance, or xyz
        table_bytes = experts * 2 * levels * tables.shape[3] * f32
        rebuild_ops = 40 if name == "encode_fwd_moe_rays" else 0  # ray -> field-local point
        bounds[name] = bound(in_bytes + table_bytes + pairs * 2 * levels * f32,
                             pairs * (levels * LATTICE_OPS + rebuild_ops))
        shapes[name] = {"tiles": n_tiles, "live_tiles": live, "pairs": pts.shape[1] * 2,
                        "live_fields": experts}
    return report_rows(rows, shapes, bounds, {})


def render_kernel_launches(permuto_cuda, topk):
    return {"topk2_fields": topk.LAUNCHES["topk2_fields"],
            "encode_fwd_moe_rays": permuto_cuda.LAUNCHES["encode_fwd_moe_rays"],
            "encode_fwd_moe": permuto_cuda.LAUNCHES["encode_fwd_moe"]}


def timed_renders(torch, ngm, c2w, camera, runs: int):
    """Median wall ms of ``runs`` renders after one warm-up (host clock
    around a render that ends in a synchronize)."""
    ngm.render_image(c2w, camera)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        ngm.render_image(c2w, camera)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def check_render(torch, permuto_cuda, topk, render_metrics, ngm, ds, smi):
    """Phase 6: the render path at 160x120 and 640x480 -> (launches, median ms)."""
    cam = ds.camera
    c2w = ds[RENDER_FRAME]["c2w"]
    target = torch.from_numpy(ds[RENDER_FRAME]["rgbd"]).to(ngm._params["w0"].device)
    block = ngm.render_block_size()
    blocks = -(-cam.height * cam.width // block)
    permuto_cuda.reset_launch_counts()
    topk.reset_launch_counts()
    rgbd, dv = ngm.render_image(c2w, cam)
    torch.cuda.synchronize()
    launches = render_kernel_launches(permuto_cuda, topk)
    if launches != {"topk2_fields": blocks, "encode_fwd_moe_rays": blocks, "encode_fwd_moe": 0}:
        raise AssertionError(f"render launches {launches}, expected {blocks} blocks on the ray route")
    if rgbd.shape != (cam.height, cam.width, 4) or not bool(torch.isfinite(rgbd).all() & torch.isfinite(dv).all()):
        raise AssertionError("render_image gave a wrong shape or non-finite values")
    psnr = render_metrics.psnr(rgbd[..., :3], target[..., :3])
    depth_l1 = render_metrics.depthl1(rgbd[..., 3], target[..., 3])
    if not (math.isfinite(psnr) and math.isfinite(depth_l1)):
        raise AssertionError(f"non-finite metrics: psnr {psnr}, depth-L1 {depth_l1}")
    ms, all_ms = timed_renders(torch, ngm, c2w, cam, 5)
    samples = ngm._eval_span_samples
    phase("render", frame=RENDER_FRAME, width=cam.width, height=cam.height, blocks=blocks,
          rays_per_block=block, samples_per_ray=samples, launches=launches, psnr_db=psnr,
          depth_l1_m=depth_l1, median_ms_per_image=ms, ms=all_ms, card=smi)

    big = cam.scaled_camera(4.0)
    big_blocks = -(-big.height * big.width // block)
    permuto_cuda.reset_launch_counts()
    topk.reset_launch_counts()
    rgbd = ngm.render_image(c2w, big)[0]
    torch.cuda.synchronize()
    big_launches = render_kernel_launches(permuto_cuda, topk)
    if big_launches["encode_fwd_moe_rays"] != big_blocks or not bool(torch.isfinite(rgbd).all()):
        raise AssertionError(f"640x480 render: launches {big_launches}, finite {bool(torch.isfinite(rgbd).all())}")
    big_ms, big_all = timed_renders(torch, ngm, c2w, big, 3)
    rays = big.height * big.width
    phase("render_640x480", width=big.width, height=big.height, blocks=big_blocks,
          launches=big_launches, median_ms_per_image=big_ms, ms=big_all,
          rays_per_s=rays / (big_ms / 1e3), samples_per_s=rays * samples / (big_ms / 1e3),
          samples=rays * samples, card=smi)
    return launches, ms


def check_render_carried(torch, permuto_cuda, topk, ngm, ds):
    """Phase 7: the carried-coordinate route, as eval_span_samples: 768 with
    eval_num_samples: 768 (the quality recipe) set it -> launches."""
    saved = ngm._eval_span_samples
    ngm._eval_span_samples = 768
    try:
        block = ngm.render_block_size()
        if block != 5461:
            raise AssertionError(f"span 768 block {block}, expected 5461 rays")
        blocks = -(-ds.camera.height * ds.camera.width // block)
        permuto_cuda.reset_launch_counts()
        topk.reset_launch_counts()
        rgbd = ngm.render_image(ds[RENDER_FRAME]["c2w"], ds.camera)[0]
        torch.cuda.synchronize()
        launches = render_kernel_launches(permuto_cuda, topk)
    finally:
        ngm._eval_span_samples = saved
    if launches != {"topk2_fields": blocks, "encode_fwd_moe_rays": 0, "encode_fwd_moe": blocks}:
        raise AssertionError(f"carried route launches {launches}, expected {blocks} blocks")
    if not bool(torch.isfinite(rgbd).all()):
        raise AssertionError("carried route render is not finite")
    phase("render_carried", span_samples=768, rays_per_block=block, blocks=blocks, launches=launches)
    return launches


def check_render_block_against_cpu(torch, engine, ngm, ds):
    """Phase 8: one 512-ray block at the full 512 samples through the ray
    route on the card and on the CPU (plain versions), same state and u."""
    cam = ds.camera
    dev = ngm._params["w0"].device
    gen = torch.Generator(dev).manual_seed(77)
    offset, rays = (cam.height // 2) * cam.width, 512
    u = torch.rand((rays, ngm._eval_span_samples), generator=gen, device=dev)
    args, kw = block_call(torch, ngm, cam, ds[RENDER_FRAME]["c2w"], offset, rays, u)
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the block raises
    try:
        gpu = engine.render_block_tiled(*args, use_ray_kernel=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_fset = copy.deepcopy(ngm._fset).to("cpu")
    cpu = engine.render_block_tiled(cpu_fset, *to_cpu(args[1:]), use_ray_kernel=True, **to_cpu(kw))
    rgb_err = float((gpu[0][:, :3].cpu() - cpu[0][:, :3]).abs().max())
    depth_err = float((gpu[0][:, 3].cpu() - cpu[0][:, 3]).abs().max())
    if not (rgb_err <= 1e-4 and depth_err <= 1e-4):
        raise AssertionError(f"render block card vs CPU: rgb {rgb_err}, depth {depth_err} > 1e-4")
    phase("render_vs_cpu", rays=rays, samples=ngm._eval_span_samples, block_offset=offset,
          max_abs_rgb=rgb_err, max_abs_depth=depth_err, tolerance="max abs <= 1e-4",
          host_syncs_in_block=0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=pathlib.Path, default=None, metavar="PATH",
                        help="also profile the steady frames; write the table to PATH")
    args = parser.parse_args()
    import torch

    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi)

    from neural_graph_mapping_tpu_torch.config import str_to_object
    from neural_graph_mapping_tpu_torch.eval import render_metrics
    from neural_graph_mapping_tpu_torch.mapping import engine
    from neural_graph_mapping_tpu_torch.ops import cuda_build, permuto_cuda, topk
    from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

    # -- 2. build (every source, one nvcc each, in parallel) -----------------
    libs = cuda_build.load_all()
    permuto_cuda.load_library()
    topk.load_library()
    phase("build", seconds=max(lib.build_seconds for lib in libs.values()),
          sources=sorted(libs),
          ptxas=[line.strip() for lib in libs.values() for line in lib.build_log.splitlines()
                 if "registers" in line or "Compiling entry" in line])

    # -- 3. kernels vs plain ------------------------------------------------
    enc_kwargs = CONFIG["model_kwargs"]["field_kwargs"]["encoding_kwargs"]
    enc = PermutohedralEncoding(**enc_kwargs)
    kernel_rows = check_kernels(torch, permuto_cuda, enc)

    # -- 4. the slice ---------------------------------------------------------
    ds = str_to_object(CONFIG["dataset_type"])(CONFIG["dataset_config"])
    ds.load_slam_results()
    frames = [torch.from_numpy(ds[i]["rgbd"]) for i in range(NUM_FRAMES)]
    ngm = engine.NeuralGraphMap(CONFIG, device="cuda")
    torch.cuda.synchronize()
    permuto_cuda.reset_launch_counts()
    topk.reset_launch_counts()
    trained, frame_s, all_losses = 0, [], []
    for fid, rgbd in enumerate(frames):
        t0 = time.perf_counter()
        losses = ngm.process_frame(ds, fid, rgbd)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if losses:
            trained += 1
            all_losses.append(losses)
    launches = {k: permuto_cuda.LAUNCHES[k] for k in ("encode_fwd", "encode_bwd_table", "batched_gather")}
    render_launches = render_kernel_launches(permuto_cuda, topk)
    if any(render_launches.values()):
        raise AssertionError(f"the frame step launched render kernels: {render_launches}")

    iters = CONFIG["num_iterations_per_frame"]
    if ngm.num_fields < CONFIG["num_train_fields"]:
        raise AssertionError(f"only {ngm.num_fields} fields allocated")
    bad = [(i, k, v) for i, d in enumerate(all_losses) for k, v in d.items() if not math.isfinite(v)]
    if bad or not all_losses:
        raise AssertionError(f"non-finite or missing losses: {bad[:5]}")
    ti_sum = int(ngm._map_arrays.training_iterations.sum().item())
    if ti_sum <= 0:
        raise AssertionError("no field was trained")
    for name, count in launches.items():
        if count != iters * trained:
            raise AssertionError(f"{name} launched {count} times, expected {iters} x {trained}")
    steady = frame_s[STEADY_FROM:]
    rays_per_frame = iters * CONFIG["num_train_fields"] * CONFIG["num_rays_per_field"]
    phase(
        "slice",
        frames=NUM_FRAMES, trained_frames=trained, fields=ngm.num_fields,
        capacity=ngm.capacity, training_iterations_sum=ti_sum, launches=launches,
        frame_ms=[round(x * 1e3, 3) for x in frame_s],
        steady_ms_per_frame_mean=statistics.mean(steady) * 1e3,
        steady_ms_per_frame_median=statistics.median(steady) * 1e3,
        steady_rays_per_s=rays_per_frame / statistics.mean(steady),
        last_losses=all_losses[-1], card=smi,
    )
    worst, losses = check_iteration_against_cpu(torch, engine, ngm)
    phase("iteration_vs_cpu", max_rel_diff=worst, tolerance="rel <= 1e-3", losses=losses)
    if args.profile is not None:
        profile_slice(torch, engine, ds, frames, statistics.mean(steady) * 1e3, args.profile)

    # -- 5-8. the render path on the trained map ------------------------------
    kernel_rows.update(check_render_kernels(torch, engine, permuto_cuda, topk, ngm, ds))
    ray_launches, render_ms = check_render(torch, permuto_cuda, topk, render_metrics, ngm, ds, smi)
    carried_launches = check_render_carried(torch, permuto_cuda, topk, ngm, ds)
    check_render_block_against_cpu(torch, engine, ngm, ds)
    if args.profile is not None:
        profile_render(torch, ngm, ds, render_ms, args.profile.with_name(args.profile.name + ".render"))
    launches.update(ray_launches)
    launches["encode_fwd_moe"] = carried_launches["encode_fwd_moe"]

    kernels = []
    for name, source, replaces in permuto_cuda.KERNELS + topk.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **kernel_rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
