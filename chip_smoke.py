#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neural_graph_mapping_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; TF32 off.
2. build: compiles ``csrc/permuto.cu`` for sm_90a into
   ``neural_graph_mapping_tpu_torch/_build/`` and prints the build seconds.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the training path's shapes, with the stated tolerance; median times of
   20 runs (CUDA events) after warm-up.
4. slice: the port's ``NeuralGraphMap.process_frame`` over 12 frames of the
   synthetic scene (160x120) at the production configuration
   (config/neural_graph_map.yaml + config/synthetic.yaml, written out below);
   checks fields, finite losses, training counts and that every kernel
   launched once per optimization iteration; then one optimization iteration
   at the same width on the card against the same iteration on the CPU
   (plain versions), same weights and draws.

    python3 chip_smoke.py --profile PATH

adds a phase after the slice: a fresh map runs the same 12 frames with
torch.profiler over frames 7-12 and prints the device kernel count, the
device-busy time and the largest device items; PATH gets the full
``key_averages()`` table. The slice's own timings never run under the
profiler.

The line before the last is a JSON summary of the kernels; the last line is
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


def check_kernels(torch, permuto_cuda, enc):
    """Phase 3: every kernel against its plain version at the path's shapes."""
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
    bound = 1e-4 * ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"encode_bwd_table max abs err {err} > {bound}")
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
    for name, err, tol, ms, plain_ms in rows:
        phase("kernel", name=name, max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
              shape={"encode_fwd": [b, p], "encode_bwd_table": [b, p],
                     "batched_gather": [slots, hw, m]}[name])
    return {name: (err, ms, plain_ms) for name, err, _, ms, plain_ms in rows}


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


def profile_slice(torch, engine, ds, frames, steady_ms, out_path: pathlib.Path) -> None:
    """--profile: torch.profiler over the steady frames of a fresh map."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ngm = engine.NeuralGraphMap(CONFIG, device="cuda")
    for fid in range(STEADY_FROM + 1):
        ngm.process_frame(ds, fid, frames[fid])
    torch.cuda.synchronize()
    profiled = frames[STEADY_FROM + 1:]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fid, rgbd in enumerate(profiled, start=STEADY_FROM + 1):
            ngm.process_frame(ds, fid, rgbd)
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
    busy_ms = busy_us / 1e3
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=200, max_name_column_width=80)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(table)
    top = sorted(averages, key=lambda a: a.self_device_time_total, reverse=True)[:12]
    n = len(profiled)
    phase(
        "profile", frames=[STEADY_FROM + 2, NUM_FRAMES], device_events=len(spans),
        device_events_per_frame=len(spans) / n, device_busy_ms=busy_ms,
        device_busy_ms_per_frame=busy_ms / n, profiled_wall_ms=wall_ms,
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_mean=1.0 - (busy_ms / n) / steady_ms,
        top_self_device_ms=[
            {"name": a.key[:80], "ms": a.self_device_time_total / 1e3, "count": a.count,
             "share": a.self_device_time_total / busy_us}
            for a in top
        ],
        table=str(out_path),
    )


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
    from neural_graph_mapping_tpu_torch.mapping import engine
    from neural_graph_mapping_tpu_torch.ops import permuto_cuda
    from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

    # -- 2. build -----------------------------------------------------------
    lib = permuto_cuda.load_library()
    regs = [line.strip() for line in lib.build_log.splitlines() if "registers" in line]
    phase("build", seconds=lib.build_seconds, ptxas=regs)

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
    trained, frame_s, all_losses = 0, [], []
    for fid, rgbd in enumerate(frames):
        t0 = time.perf_counter()
        losses = ngm.process_frame(ds, fid, rgbd)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if losses:
            trained += 1
            all_losses.append(losses)
    launches = dict(permuto_cuda.LAUNCHES)

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

    kernels = []
    for name, source, replaces in permuto_cuda.KERNELS:
        err, ms, plain_ms = kernel_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
