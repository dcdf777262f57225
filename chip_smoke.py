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
   started together) and prints the build seconds; kernel_resources: each
   device kernel's registers, stack frame and spill bytes (``-Xptxas -v``),
   its local-memory loads and stores (LDL, STL in ``cuobjdump -sass``) and
   its SASS instruction counts (:func:`sass_counts`).
3. lattice: the kernels' ``lattice_level`` (``ngm_lattice_debug``) against
   the plain ``lattice_keys_and_weights_soa`` on the card and on the CPU,
   for uniform points and points built to sit on every level's rounding
   boundaries (``lattice_boundary_points``): indices exact, weights within
   1e-6. kernels (training): each training kernel against its plain
   PyTorch version on the card, at the training path's shapes, with the
   stated tolerance, and timed (see "Kernel times" below).
   ``encode_fwd``'s line names its variant (staged); a ``kernel_variant``
   line checks and times its direct variant (log2_hashmap_size 14,
   T = 16,384). ``encode_bwd_table``'s line names its variant and times it
   with the cotangent on the two coarsest and on the two finest levels only
   (``contention``); a ``kernel_variant`` line checks and times its direct
   variant at T = 16,384. Then the fused pair ``encode_mlp_fwd`` /
   ``encode_mlp_bwd`` at the same shapes and production widths (D = 32,
   H = 32, O = 4), beside the unfused route's time for the same work.
   ``encode_mlp_fwd``'s line names its variant and its two device kernels,
   and its residual must equal ``encode_fwd``'s output bit for bit; a
   ``kernel_variant`` line checks and times its direct variant at
   T = 16,384.
   ``encode_mlp_bwd``'s line names its variant and the device kernels one
   call launches (two on the staged design) and has its ``contention``
   (dL/df on the coarse or the fine levels only, by zeroing w0's other
   rows; there the cotangent is zeroed at points on a ReLU kink,
   :func:`off_the_relu_kink`); a ``kernel_variant`` line checks and times
   its direct variant at T = 16,384.
4. slice: the port's ``NeuralGraphMap.process_frame`` over 12 frames of the
   synthetic scene (160x120) at the production configuration
   (config/neural_graph_map.yaml + config/synthetic.yaml, written out below);
   checks fields, finite losses, training counts and that every training
   kernel launched once per optimization iteration; then one optimization
   iteration at the same width on the card against the same iteration on
   the CPU (plain versions), same weights and draws. kernel_captured:
   ``encode_bwd_table`` at the inputs that iteration gave it, against its
   plain version and timed (``captured_ms`` in its kernel line), and the
   same for ``encode_fwd``.
   slice_fused_mlp: a fresh map with ``fused_mlp: true`` over the same
   frames: only the fused pair trains (once per iteration each), steady ms a
   frame beside the unfused slice's; one iteration against the CPU and
   against the unfused route on the card; kernel_captured:
   ``encode_mlp_fwd`` at the inputs that iteration gave it, against its
   plain version and timed, and ``encode_mlp_bwd`` at its inputs, against its
   plain version with the cotangent off the ReLU kink (the error on the
   inputs as given beside it) and timed (``captured_ms`` in its line).
5. kernels (render): the three render kernels against their plain versions
   at the shapes of one production render block of the trained map (8192
   rays x 512 samples x k = 2 = 8,388,608 pairs): ``topk2_fields`` exact on
   all 4,194,304 points, with the share of (point, centre) pairs it
   evaluated (each box's surviving centres, counted by the kernel in a
   launch of its own and equal to its plain model's), the two
   MoE encodes within 1e-5 on 256 live tiles (tables U(-1, 1)), timed;
   their lines give the block's live tiles, live pairs and field runs and
   name their device kernel (one body, by point source). ``kernel_variant``
   lines check and time ``topk2_fields`` at 1,024 centres (the map's slots
   and seeded centres in its box, as ``benchmarks/scale_sweep.py`` grows a
   map), both MoE encodes on the same block with tables of T = 16,384, and
   the carried encode with a field change at every tile.
6. render: ``NeuralGraphMap.render_image`` of frame 11's pose on the trained
   map at 160x120 (PSNR and depth-L1 against the frame, median ms of 5
   renders, each render kernel launched once per block) and at 640x480
   (ms per image, rays/s, samples/s).
7. render_carried: a 160x120 render at ``eval_span_samples: 768`` (k * S
   not a power of two): ``encode_fwd_moe`` once per block, the ray kernel
   never; median ms of 5 renders.
8. render_vs_cpu: one 512-ray block at 512 samples on the card and on the
   CPU (plain versions), same state and jitter, max abs <= 1e-4; the card's
   block runs under ``torch.cuda.set_sync_debug_mode("error")``, so a host
   sync inside it fails the run.
9. field2d: a 2D permutohedral field set at the production encoding widths
   (32 fields x 12,288 points) through ``apply_vmap``, the gather route:
   forward and backward on the card against the CPU, ``gather_pairs`` and
   ``table_grad`` against their plain versions at the shapes it gave them
   (``kernel`` lines; both take their staged variants there), the direct
   variant of ``gather_pairs`` at that shape with an unaligned table and at
   T = 16,384, ``table_grad`` with unaligned values (scalar loads) and its
   direct variant at T = 16,384 (``kernel_variant`` lines),
   five Adam steps of a fit that must lower its loss.
10. geometry_gradients: one trained field at 4,096 points, card against CPU.
11. cli: the port's CLI runner (``run_mapping.NeuralGraphMapRunner``) on the
    card at config/synthetic.yaml's own settings (60 frames, eval_ratio 0.1,
    eval_chunk_freq 5, psnr and depth-L1, a mesh at 0.04 m, frames read and
    uploaded ahead by the prefetcher, a full checkpoint) in a temporary
    directory: fit wall s, ``fps_estimate`` / ``spf_estimate``, the host
    phases, online and final PSNR and depth-L1, the mesh's vertices and
    faces, ``extract_mesh`` seconds split into field evaluation (the card)
    and marching tetrahedra (the host), and the launches meshing made:
    ``topk2_fields`` and ``encode_fwd_moe`` (carried points) each > 0, the
    ray encode none.
12. cli_mesh_vs_cpu: of the CLI's meshing launches (262,144 grid points of
    a block 128 voxels a side), the one with the most points near the
    surface, at its own shape: its volume on the card against the CPU's
    plain route, max abs <= 1e-4, and the CPU's seconds.
13. cli_resume: a fresh runner on the card loads the full checkpoint; its
    render of a held-out frame equals the saving runner's within 1e-4 (the
    same generator state), then it trains two more frames, losses finite.

Kernel times: ``ms`` is device time a launch, with the host's issue hidden:
a device-side delay long enough for the host to queue 20 launches, then
CUDA events around them (``time_ms``; it raises if the delay did not cover
the issue). ``host_us`` is the wrapper's host cost a call (a host clock over
20 calls with no sync in between). The kernel and, where one exists, the
one PyTorch call of the same function (``library_ms``) are timed in turns,
library, kernel, kernel, library; ``ms`` and ``library_ms`` are the means
of the two turns. Plain versions that issue thousands of launches a call
cannot be queued behind a delay: their ``plain_ms`` is an event window
from an idle device (``plain_timing`` says which).

    python3 chip_smoke.py --profile PATH

adds a phase after the slice: a fresh map runs the same 12 frames with
torch.profiler over frames 7-12 and prints the device kernel count, the
device-busy time and the largest device items; PATH gets the full
``key_averages()`` table. The same for a fresh ``fused_mlp`` map after the
fused slice (PATH with ``.fused`` added), and for one 160x120 render of the
trained map (PATH with ``.render`` added). The timed phases never run under
the profiler.

    python3 chip_smoke.py --ab ROUNDS

adds a phase after the fused slice: fresh maps over the same 12 frames on
the two training routes in turns, ROUNDS x (unfused, fused, fused,
unfused), each run's steady median ms a frame, and in how many of the
2 x ROUNDS pairs the fused route was faster.

The line before the last is a JSON summary of the ten kernels (launches
from the path that runs each: training kernels from the 12 frames, the
fused pair from the fused slice, the render kernels from one render of
their route, the gather route's pair from the 2D fit; ``topk2_fields`` and
``encode_fwd_moe`` also give ``meshing_launches``, from the cli phase's
mesh); the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import copy
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
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


def lattice_boundary_points(scales, shifts, elev, per_level: int = 128, seed: int = 0, ulps: int = 2):
    """(3, N) f32 field-local points built to sit on the lattice's rounding
    boundaries, level by level (numpy; N = 30,720 at the production 16
    levels): coordinates that are integer and half-integer multiples of a
    level's scale minus its shift, and points whose elevated coordinates 1-3
    are 4m + 2, where rounding to the nearest remainder-0 point is a tie;
    each also moved by 1 and ``ulps`` f32 ulps either way. A corner picked
    differently at such a point has near-zero weight, which an encode's
    output cannot show."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scales = np.asarray(scales, np.float64)
    shifts = np.asarray(shifts, np.float64).reshape(-1, 3)
    elev = np.asarray(elev, np.float64)[:, None]
    base = []
    for s, sh in zip(scales, shifts):
        sh = sh[:, None]
        u = rng.uniform(-0.5, 1.5, (3, per_level)) / s + sh  # before elevation
        base.append((np.round(u) - sh) * s)
        base.append((np.round(u - 0.5) + 0.5 - sh) * s)
        cf = u * elev
        c2 = -(4 * np.round((-3 * cf[2] - 2) / 4) + 2) / 3  # elevated[3] = -3 c2
        c1 = (c2 - 4 * np.round((c2 - 2 * cf[1] - 2) / 4) - 2) / 2  # elevated[2] = c2 - 2 c1
        c0 = c1 + c2 - 4 * np.round((c1 + c2 - cf[0] - 2) / 4) - 2  # elevated[1] = c1 + c2 - c0
        base.append((np.stack([c0, c1, c2]) / elev - sh) * s)
    pts = np.concatenate(base, axis=1).astype(np.float32)
    out = [pts]
    for direction in (np.float32(np.inf), np.float32(-np.inf)):
        q = pts
        for _ in range(ulps):
            q = np.nextafter(q, direction)
            out.append(q)
    return np.concatenate(out, axis=1)


def phase(phase_name: str, **fields) -> None:
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


_MS_PER_SLEEP_CYCLE = []


def ms_per_sleep_cycle(torch) -> float:
    """Device ms of one cycle of ``torch.cuda._sleep``, from one event-timed
    sleep of 10M cycles (measured once)."""
    if not _MS_PER_SLEEP_CYCLE:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _MS_PER_SLEEP_CYCLE.append(start.elapsed_time(end) / 10_000_000)
    return _MS_PER_SLEEP_CYCLE[0]


def time_ms(torch, fn, runs: int = 20, warmup: int = 3):
    """(device ms a call, host us a call) of fn over ``runs`` calls.

    Host: a host clock over the runs issued back to back, one synchronize
    after the window. Device: a device-side delay (``torch.cuda._sleep``)
    twice as long as that issue plus 1 ms, then CUDA events around the runs,
    so the device finds every call queued and elapsed / runs is device time
    alone. Raises if the delay did not cover the issue (the start event was
    reached before the last call was issued, or the issue outlasted the
    delay), after two retries with a four times longer delay."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    delay_ms = 2.0 * host_ms + 1.0
    for _ in range(3):
        torch.cuda._sleep(int(delay_ms / ms_per_sleep_cycle(torch)))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        reached = start.query()
        end.record()
        end.synchronize()
        if not reached and issue_ms < delay_ms:
            return start.elapsed_time(end) / runs, host_ms * 1e3 / runs
        delay_ms *= 4.0
    raise AssertionError(f"a {delay_ms / 4.0:.3f} ms device-side delay did not cover the host's "
                         f"issue of {runs} calls ({issue_ms:.3f} ms)")


def window_ms(torch, fn, runs: int = 3, warmup: int = 1) -> float:
    """Device ms a call of a plain version that issues more launches than the
    launch queue holds, so that no delay can hide its issue: CUDA events
    around ``runs`` calls from an idle device (the host's issue is inside the
    window wherever the device waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def measure(torch, kernel, plain, library=None, plain_window: bool = False) -> dict:
    """A kernel row's times: the kernel and, where there is one, the one
    PyTorch call of the same function, by :func:`time_ms` in turns
    (library, kernel, kernel, library); then the plain version, by
    :func:`time_ms` or, for a plain version that issues thousands of
    launches (``plain_window``), by :func:`window_ms`."""
    lib, ker = [], []
    if library is not None:
        lib.append(time_ms(torch, library))
    ker += [time_ms(torch, kernel), time_ms(torch, kernel)]
    if library is not None:
        lib.append(time_ms(torch, library))
    row = dict(ms=statistics.mean(t[0] for t in ker), ms_turns=[t[0] for t in ker],
               host_us=statistics.mean(t[1] for t in ker), library_ms=None)
    if lib:
        row.update(library_ms=statistics.mean(t[0] for t in lib), library_turns=[t[0] for t in lib],
                   library_host_us=statistics.mean(t[1] for t in lib))
    if plain_window:
        row.update(plain_ms=window_ms(torch, plain), plain_timing="window, host issue included")
    else:
        row.update(plain_ms=time_ms(torch, plain)[0], plain_timing="device, host issue hidden")
    return row


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for work that moves n_bytes and does n_ops."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sass_counts(sass: str) -> dict:
    """Static instruction counts of one device kernel's SASS (the text
    ``cuobjdump -sass`` prints for it): ``sass_instructions`` (all but NOP)
    and ``divisions`` (FCHK, one per IEEE f32 division's fast path)."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass)
    return {"sass_instructions": sum(op != "NOP" for op in ops), "divisions": ops.count("FCHK")}


def kernel_resources(cuda_build, libs) -> list:
    """Per device kernel of every built source, read from the binary:
    registers, stack and local-memory bytes (``cuobjdump -res-usage``),
    spill bytes where this run compiled the source (``nvcc -Xptxas -v``),
    the local-memory loads and stores (LDL, STL) in its SASS
    (``cuobjdump -sass``) and its static instruction counts
    (:func:`sass_counts`)."""
    cuobjdump = str(pathlib.Path(cuda_build._find_nvcc()).with_name("cuobjdump"))
    rows = {}
    for source, lib in libs.items():
        so = str(cuda_build._target(source))
        usage = subprocess.run([cuobjdump, "-res-usage", so], capture_output=True, text=True,
                               check=True, timeout=120).stdout
        for m in re.finditer(r"Function (\w+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", usage):
            rows.setdefault(m.group(1), {"source": source}).update(
                registers=int(m.group(2)), stack_bytes=int(m.group(3)), static_shared_bytes=int(m.group(4)),
                local_bytes=int(m.group(5)))
        fn = None
        for line in lib.build_log.splitlines():
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn in rows:
                rows[fn].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            fn = part.split(None, 1)[0]
            rows.setdefault(fn, {"source": source}).update(
                ldl=len(re.findall(r"\bLDL\b", part)), stl=len(re.findall(r"\bSTL\b", part)),
                **sass_counts(part))
    names = list(rows)
    demangled = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines()
    out = []
    for mangled, name in zip(names, demangled):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
        out.append({"kernel": name, **rows[mangled]})
    return out


def check_lattice(torch, permuto_cuda, enc) -> dict:
    """Phase lattice: the kernels' lattice_level (ngm_lattice_debug) against
    the plain lattice_keys_and_weights_soa, on the card and on the CPU, for
    100,000 uniform points and the boundary points of every level:
    indices exact, weights within 1e-6."""
    import numpy as np

    from neural_graph_mapping_tpu_torch.ops import permuto

    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    rng = np.random.default_rng(31)
    sets = {"uniform": rng.uniform(-0.5, 1.5, (3, 100_000)).astype(np.float32),
            "boundary": lattice_boundary_points(*consts[:3])}
    out = {}
    for case, pts in sets.items():
        coords = torch.from_numpy(pts).cuda()
        idx, w = permuto_cuda.lattice_debug(coords, *consts)
        s, sh, el = (torch.tensor(v, dtype=torch.float32, device=coords.device) for v in consts[:3])
        for where, c in (("card", coords), ("cpu", coords.cpu())):
            s_, sh_, el_ = (v.to(c.device) for v in (s, sh, el))
            want_idx, want_w = permuto.lattice_keys_and_weights_soa(c.unbind(0), s_, sh_, el_, consts[3])
            mismatched = int((idx.to(c.device) != want_idx).sum())
            w_err = max_err(torch, w.to(c.device), want_w)
            if mismatched or not w_err <= 1e-6:
                raise AssertionError(f"lattice ({case}, plain on the {where}): {mismatched} corner "
                                     f"indices differ, weights within {w_err}")
            out[f"{case}_vs_{where}"] = {"index_mismatches": mismatched, "max_abs_weight_err": w_err}
        out[f"{case}_points"] = pts.shape[1]
        out[f"{case}_near_zero_weights"] = int((w.abs() < 1e-6).sum())
    phase("lattice", levels=len(consts[0]), tolerance="indices exact, weights max abs <= 1e-6", **out)
    return out


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
        "encode_bwd_table": encode_bwd_table_bound(coords, g, n_levels, t),
        # per lookup: an 8-byte index and the 4-byte value it needs in, 4 out
        "batched_gather": bound(idx.numel() * (8 + 4 + 4), 0),
    }
    rows = []
    err = check_encode_fwd(torch, permuto_cuda, table, coords, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_fwd(table, coords, *consts),
                     lambda: permuto_cuda.encode_fwd_plain(table, coords, *consts), plain_window=True)
    timing.update(variant=permuto_cuda.encode_fwd_variant(table))
    rows.append(("encode_fwd", err, "max abs <= 1e-5", timing))

    err = check_encode_bwd_table(torch, permuto_cuda, coords, g, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_bwd_table(coords, g, *consts),
                     lambda: permuto_cuda.encode_bwd_table_plain(coords, g, *consts, t), plain_window=True)
    timing.update(variant=permuto_cuda.encode_bwd_table_variant(coords, consts[0], consts[3]),
                  contention=histogram_contention(torch, permuto_cuda, coords, g, consts))
    rows.append(("encode_bwd_table", err, "max abs <= 1e-4 * max|plain|", timing))

    out = permuto_cuda.batched_gather(values, idx)
    ref = permuto_cuda.batched_gather_plain(values, idx)
    if not torch.equal(out, ref):
        raise AssertionError("batched_gather differs from torch.gather")
    rows.append(("batched_gather", (out - ref).abs().max().item(), "exact",
                 measure(torch, lambda: permuto_cuda.batched_gather(values, idx),
                         lambda: permuto_cuda.batched_gather_plain(values, idx),
                         library=lambda: torch.gather(values, 1, idx))))
    shapes = {"encode_fwd": [b, p], "encode_bwd_table": [b, p], "batched_gather": [slots, hw, m]}
    kernel_rows = report_rows(rows, shapes, bounds)
    check_encode_fwd_direct(torch, permuto_cuda, enc, coords, gen)
    check_encode_bwd_table_direct(torch, permuto_cuda, enc, coords, g)
    return kernel_rows


def check_encode_fwd(torch, permuto_cuda, table, coords, consts) -> float:
    """encode_fwd against its plain version -> max abs error; raises above
    1e-5."""
    out = permuto_cuda.encode_fwd(table, coords, *consts)
    err = max_err(torch, out, permuto_cuda.encode_fwd_plain(table, coords, *consts))
    if not err <= 1e-5:
        raise AssertionError(f"encode_fwd max abs err {err} > 1e-5")
    return err


def big_table_consts(enc):
    """The encoding with log2_hashmap_size 14 (levels of up to 16,384
    entries, a 128 KB (2, T) row pair, above the staged maximum) -> (that
    encoding, its lattice constants)."""
    kwargs = dict(CONFIG["model_kwargs"]["field_kwargs"]["encoding_kwargs"], log2_hashmap_size=14)
    big = type(enc)(**kwargs)
    return big, (big._scales_t, big._shifts_t, big._elev_t, big.level_capacities)


def check_encode_fwd_direct(torch, permuto_cuda, enc, coords, gen) -> None:
    """Phase kernel_variant: encode_fwd's direct variant (4 levels a thread,
    corners read through L2) at the training shape with log2_hashmap_size
    14, whose level rows are above the staged maximum."""
    big, consts = big_table_consts(enc)
    table = torch.rand((coords.shape[0], 2, big.nr_levels, big.capacity), generator=gen,
                       device=coords.device) * 2 - 1
    variant = permuto_cuda.encode_fwd_variant(table)
    if variant != "direct":
        raise AssertionError(f"encode_fwd took the {variant} variant at T = {big.capacity}")
    err = check_encode_fwd(torch, permuto_cuda, table, coords, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_fwd(table, coords, *consts),
                     lambda: permuto_cuda.encode_fwd_plain(table, coords, *consts), plain_window=True)
    n_bytes = (table.numel() + coords.numel() + coords.shape[0] * 2 * big.nr_levels * coords.shape[-1]) * 4
    bound_ms, bound_by = bound(n_bytes, coords.shape[0] * coords.shape[-1] * big.nr_levels * LATTICE_OPS)
    phase("kernel_variant", name="encode_fwd", variant=variant,
          case=f"level rows above the staged maximum (log2_hashmap_size 14, T = {big.capacity})",
          tolerance="max abs <= 1e-5", max_abs_err=err,
          shape={"fields": coords.shape[0], "points": coords.shape[-1], "table": big.capacity},
          **timing, bound_ms=bound_ms, bound_by=bound_by)


def encode_bwd_table_bound(coords, g, n_levels: int, t: int):
    """(least ms, what bounds it) of encode_bwd_table: coordinates and
    cotangent in, the (B, 2, L, T) gradient out; the lattice and 16 f32
    operations of adds a point and level with a nonzero cotangent."""
    b = coords.shape[0]
    live = int(((g[:, 0::2] != 0) | (g[:, 1::2] != 0)).sum())
    return bound((coords.numel() + g.numel() + b * 2 * n_levels * t) * 4, live * (LATTICE_OPS + 16))


def check_encode_bwd_table_direct(torch, permuto_cuda, enc, coords, g) -> None:
    """Phase kernel_variant: encode_bwd_table's direct variant (every corner
    value added into device memory with a global atomic: the first design)
    at the training shape with log2_hashmap_size 14, levels of up to 16,384
    entries, whose 128 KB (2, T) histogram is above the staged maximum."""
    big, consts = big_table_consts(enc)
    variant = permuto_cuda.encode_bwd_table_variant(coords, consts[0], consts[3])
    if variant != "direct":
        raise AssertionError(f"encode_bwd_table took the {variant} variant at T = {big.capacity}")
    err = check_encode_bwd_table(torch, permuto_cuda, coords, g, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_bwd_table(coords, g, *consts),
                     lambda: permuto_cuda.encode_bwd_table_plain(coords, g, *consts, big.capacity),
                     plain_window=True)
    bound_ms, bound_by = encode_bwd_table_bound(coords, g, big.nr_levels, big.capacity)
    phase("kernel_variant", name="encode_bwd_table", variant=variant,
          case=f"histogram above the staged maximum (log2_hashmap_size 14, T = {big.capacity})",
          tolerance="max abs <= 1e-4 * max|plain|", max_abs_err=err,
          shape={"fields": coords.shape[0], "points": coords.shape[-1], "table": big.capacity},
          **timing, bound_ms=bound_ms, bound_by=bound_by)


def check_encode_bwd_table(torch, permuto_cuda, coords, g, consts) -> float:
    """encode_bwd_table against its plain version -> max abs error; raises
    above 1e-4 * max|plain| (atomics change the summation order)."""
    out = permuto_cuda.encode_bwd_table(coords, g, *consts)
    ref = permuto_cuda.encode_bwd_table_plain(coords, g, *consts, max(consts[3]))
    err = max_err(torch, out, ref)
    limit = 1e-4 * float(ref.abs().max())
    if not err <= limit:
        raise AssertionError(f"encode_bwd_table max abs err {err} > {limit}")
    return err


def histogram_contention(torch, permuto_cuda, coords, g, consts) -> dict:
    """Device ms of encode_bwd_table with the cotangent kept on the two
    coarsest levels only (512 and 1,024 entries: many points a cell) and on
    the two finest only (4,096: few), each checked against the plain
    version first."""
    dev = g.device
    n_levels = len(consts[0])
    level = torch.arange(2 * n_levels, device=dev)[:, None] // 2
    cases = {"coarse_only": g * (level < 2), "fine_only": g * (level >= n_levels - 2)}
    out = {}
    for case, gc in cases.items():
        check_encode_bwd_table(torch, permuto_cuda, coords, gc, consts)
        out[f"{case}_ms"] = time_ms(torch, lambda: permuto_cuda.encode_bwd_table(coords, gc, *consts))[0]
    return out


def report_rows(rows, shapes, bounds, extra=None):
    """Print one kernel phase line per row; -> {name: measurements}.
    ``extra`` adds keys to a row (the unfused route's time of a fused kernel)."""
    out = {}
    for name, err, tol, timing in rows:
        bound_ms, bound_by = bounds[name]
        row = dict(max_abs_err=err, **timing, bound_ms=bound_ms, bound_by=bound_by,
                   **(extra or {}).get(name, {}))
        phase("kernel", name=name, tolerance=tol, shape=shapes[name], **row)
        out[name] = row
    return out


def max_err(torch, got, want, relative=False):
    """max |got - want|, or that over max |want| with ``relative``."""
    err = float((got - want).abs().max())
    return err / max(float(want.abs().max()), 1e-30) if relative else err


def check_fused_kernels(torch, permuto_cuda, enc):
    """Kernels 9-10, the fused encode + MLP pair, against their plain
    versions at the frame step's shapes and production widths (D = 32,
    H = 32, O = 4); beside each, the unfused route's time for the same work
    (encode_fwd + the bmm MLP; the MLP's autograd + encode_bwd_table)."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(4242)
    b, p = 32, 512 * 24
    n_levels, t = enc.nr_levels, enc.capacity
    d, h, o = 2 * n_levels, 32, 4
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    table = uniform((b, 2, n_levels, t), 1.0)
    coords = torch.rand((b, 3, p), generator=gen, device=dev) * 1.5 - 0.25
    w0, b0 = uniform((b, d, h), d ** -0.5), uniform((b, h), d ** -0.5)  # nn.Linear's init
    w1, b1 = uniform((b, h, o), h ** -0.5), uniform((b, o), h ** -0.5)
    g = torch.randn((b, o, p), generator=gen, device=dev)
    weights = (w0, b0, w1, b1)

    err, feats, ref_feats = check_encode_mlp_fwd(torch, permuto_cuda, (table, *weights, coords, *consts))
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_fwd(table, *weights, coords, *consts),
                     lambda: permuto_cuda.encode_mlp_fwd_plain(table, *weights, coords, *consts),
                     plain_window=True)
    variant = permuto_cuda.encode_mlp_fwd_variant(table)
    timing.update(variant=variant, device_kernels=list(MLP_FWD_DEVICE_KERNELS[variant]))
    rows = [("encode_mlp_fwd", err, MLP_FWD_TOLERANCE, timing)]
    check_encode_mlp_fwd_direct(torch, permuto_cuda, enc, weights, coords, gen)


    bwd_args = (coords, feats, g, w0, b0, w1, *consts)
    err, w_err = check_encode_mlp_bwd(torch, permuto_cuda, bwd_args)
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_bwd(*bwd_args),
                     lambda: permuto_cuda.encode_mlp_bwd_plain(*bwd_args), plain_window=True)
    variant = permuto_cuda.encode_mlp_bwd_variant(coords, consts[0], consts[3])
    timing.update(variant=variant,
                  device_kernels=list(MLP_BWD_DEVICE_KERNELS["direct" if variant == "direct" else "staged"]),
                  contention=mlp_bwd_contention(torch, permuto_cuda, bwd_args))
    rows.append(("encode_mlp_bwd", err,
                 "table gradient max abs <= 1e-4 * max|plain| (atomics); weight gradients "
                 f"<= 1e-4 relative (got {w_err:.2e})", timing))
    check_encode_mlp_bwd_direct(torch, permuto_cuda, enc, bwd_args)

    # the unfused route on the same inputs: encode_fwd + the bmm MLP, and
    # the MLP's autograd (from a kept graph, as training has) + encode_bwd_table
    def unfused_fwd():
        return permuto_cuda.mlp_plain(permuto_cuda.encode_fwd(table, coords, *consts), *weights)

    leaves = [x.detach().requires_grad_(True) for x in (ref_feats, *weights)]
    with torch.enable_grad():
        mlp_out = permuto_cuda.mlp_plain(*leaves)

    def unfused_bwd():
        dfeats = torch.autograd.grad(mlp_out, leaves, g, retain_graph=True)[0]
        return permuto_cuda.encode_bwd_table(coords, dfeats, *consts)

    unfused = {"encode_mlp_fwd": {"unfused_ms": time_ms(torch, unfused_fwd)[0]},
               "encode_mlp_bwd": {"unfused_ms": time_ms(torch, unfused_bwd, runs=10)[0]}}
    bounds = {
        "encode_mlp_fwd": mlp_fwd_bound((table, *weights, coords)),
        "encode_mlp_bwd": mlp_bwd_bound(bwd_args, t),
    }
    shapes = {name: {"fields": b, "points": p, "D": d, "H": h, "O": o} for name in bounds}
    return report_rows(rows, shapes, bounds, unfused)


MLP_FWD_TOLERANCE = "max abs <= 1e-5 (outputs and residual); residual equal to encode_fwd's"
# The device kernels one encode_mlp_fwd call launches, by design.
MLP_FWD_DEVICE_KERNELS = {
    "staged": ("encode_fwd_staged_kernel", "mlp_fwd_kernel"),
    "direct": ("encode_fwd_kernel", "mlp_fwd_kernel"),
}


def check_encode_mlp_fwd(torch, permuto_cuda, args):
    """encode_mlp_fwd against its plain version -> (max abs error of the
    outputs and the residual, the residual, the plain residual); raises
    above 1e-5, or where the residual differs from encode_fwd's output on
    the same inputs in any bit."""
    table, coords, consts = args[0], args[5], args[6:]
    out, feats = permuto_cuda.encode_mlp_fwd(*args)
    ref_out, ref_feats = permuto_cuda.encode_mlp_fwd_plain(*args)
    err = max(max_err(torch, out, ref_out), max_err(torch, feats, ref_feats))
    if not err <= 1e-5:
        raise AssertionError(f"encode_mlp_fwd max abs err {err} > 1e-5")
    if not torch.equal(feats, permuto_cuda.encode_fwd(table, coords, *consts)):
        raise AssertionError("encode_mlp_fwd's residual differs from encode_fwd's output")
    return err, feats, ref_feats


def mlp_fwd_bound(args):
    """(least ms, what bounds it) of encode_mlp_fwd: tables, weights and
    coordinates in, the residual and outputs out; the lattice and the MLP's
    2 (D H + H O) operations a point."""
    table, w0, b0, w1, b1, coords = args[:6]
    b, p = coords.shape[0], coords.shape[-1]
    d, h = w0.shape[-2:]
    o = w1.shape[-1]
    weight_bytes = (d * h + h + h * o + o) * b * 4
    return bound(table.numel() * 4 + weight_bytes + b * p * (3 + d + o) * 4,
                 b * p * ((d // 2) * LATTICE_OPS + 2 * (d * h + h * o)))


def check_encode_mlp_fwd_direct(torch, permuto_cuda, enc, weights, coords, gen) -> None:
    """Phase kernel_variant: encode_mlp_fwd's direct design (encode_fwd's
    direct kernel, then the MLP pass) at the training shape with
    log2_hashmap_size 14, whose level rows are above the staged maximum."""
    big, consts = big_table_consts(enc)
    table = torch.rand((coords.shape[0], 2, big.nr_levels, big.capacity), generator=gen,
                       device=coords.device) * 2 - 1
    args = (table, *weights, coords, *consts)
    variant = permuto_cuda.encode_mlp_fwd_variant(table)
    if variant != "direct":
        raise AssertionError(f"encode_mlp_fwd took the {variant} design at T = {big.capacity}")
    err = check_encode_mlp_fwd(torch, permuto_cuda, args)[0]
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_fwd(*args),
                     lambda: permuto_cuda.encode_mlp_fwd_plain(*args), plain_window=True)
    bound_ms, bound_by = mlp_fwd_bound(args)
    phase("kernel_variant", name="encode_mlp_fwd", variant=variant,
          device_kernels=list(MLP_FWD_DEVICE_KERNELS[variant]),
          case=f"level rows above the staged maximum (log2_hashmap_size 14, T = {big.capacity})",
          tolerance=MLP_FWD_TOLERANCE, max_abs_err=err,
          shape={"fields": coords.shape[0], "points": coords.shape[-1], "table": big.capacity},
          **timing, bound_ms=bound_ms, bound_by=bound_by)


def check_captured_encode_mlp_fwd(torch, permuto_cuda, call) -> dict:
    """Phase kernel_captured: encode_mlp_fwd at the inputs one fused
    training iteration of the 12-frame map gave it, against its plain
    version and timed -> the fields it adds to the kernel row."""
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a for a in call[0])
    table, coords = args[0], args[5]
    err = check_encode_mlp_fwd(torch, permuto_cuda, args)[0]
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_fwd(*args),
                     lambda: permuto_cuda.encode_mlp_fwd_plain(*args), plain_window=True)
    bound_ms, bound_by = mlp_fwd_bound(args)
    phase("kernel_captured", name="encode_mlp_fwd", variant=permuto_cuda.encode_mlp_fwd_variant(table),
          shape={"fields": coords.shape[0], "points": coords.shape[-1]}, tolerance=MLP_FWD_TOLERANCE,
          max_abs_err=err, **timing, bound_ms=bound_ms, bound_by=bound_by)
    return {"captured_ms": timing["ms"], "captured_max_abs_err": err, "captured_bound_ms": bound_ms}


MLP_BWD_TOLERANCE = "table gradient max abs <= 1e-4 * max|plain|; weight gradients <= 1e-4 relative"
# The device kernels one encode_mlp_bwd call launches, by design.
MLP_BWD_DEVICE_KERNELS = {
    "staged": ("mlp_bwd_kernel", "encode_bwd_table_staged_kernel"),
    "direct": ("encode_mlp_bwd_kernel",),
}


def off_the_relu_kink(torch, args, margin: float = 1e-5):
    """encode_mlp_bwd's arguments with the head cotangent zeroed at every
    point one of whose pre-activations lies within ``margin`` of 0 (relative
    to the field's largest, computed in f64) -> (args, such points). The
    kernels sum a pre-activation in another order than the plain version's
    matrix product, so at such a point the two may disagree on the ReLU
    mask, and the point's whole dL/df with it (an O(|w0| |dh|) difference,
    where atomics give O(1e-7)); with no cotangent the mask changes nothing."""
    coords, feats, g, w0, b0 = args[:5]
    a = torch.matmul(w0.double().transpose(-1, -2), feats.double()) + b0.double()[..., None]
    scale = a.abs().amax(dim=(-2, -1), keepdim=True)
    near = (a.abs() <= margin * scale).any(dim=-2)  # (..., P)
    g = torch.where(near[..., None, :], torch.zeros_like(g), g)
    return (coords, feats, g, *args[3:]), int(near.sum())


def check_encode_mlp_bwd(torch, permuto_cuda, args):
    """encode_mlp_bwd against its plain version -> (table gradient max abs
    error, worst weight-gradient error relative to its largest entry);
    raises above 1e-4 x max|plain| and 1e-4 relative."""
    got = permuto_cuda.encode_mlp_bwd(*args)
    want = permuto_cuda.encode_mlp_bwd_plain(*args)
    errs = [max_err(torch, a, w, relative=True) for a, w in zip(got, want)]
    if not (errs[0] <= 1e-4 and max(errs[1:]) <= 1e-4):
        raise AssertionError(f"encode_mlp_bwd relative errors {errs} > 1e-4")
    return max_err(torch, got[0], want[0]), max(errs[1:])


def mlp_bwd_contention(torch, permuto_cuda, args) -> dict:
    """Device ms of encode_mlp_bwd with dL/df kept on the two coarsest levels
    only (the rows of w0 of every other level zeroed; 512 and 1,024 entries:
    many points a cell) and on the two finest only (4,096: few), each
    checked against the plain version first, with no cotangent at points on
    a ReLU kink (:func:`off_the_relu_kink`; with dL/df on two levels, one
    point whose mask differs exceeds 1e-4 x max|plain|)."""
    coords, feats, g, w0, *rest = args
    n_levels = w0.shape[-2] // 2
    level = torch.arange(2 * n_levels, device=w0.device)[:, None] // 2
    cases = {"coarse_only": w0 * (level < 2), "fine_only": w0 * (level >= n_levels - 2)}
    out = {}
    for case, wc in cases.items():
        case_args, kink_points = off_the_relu_kink(torch, (coords, feats, g, wc, *rest))
        check_encode_mlp_bwd(torch, permuto_cuda, case_args)
        out[f"{case}_ms"] = time_ms(torch, lambda: permuto_cuda.encode_mlp_bwd(*case_args))[0]
        out[f"{case}_kink_points"] = kink_points
    return out


def check_encode_mlp_bwd_direct(torch, permuto_cuda, enc, args) -> None:
    """Phase kernel_variant: encode_mlp_bwd's direct variant (one kernel,
    global atomics: the first design) at the training shape with
    log2_hashmap_size 14, levels of up to 16,384 entries, whose (2, T)
    histogram is above the staged maximum."""
    big, consts = big_table_consts(enc)
    big_args = tuple(args[:6]) + consts
    coords = args[0]
    variant = permuto_cuda.encode_mlp_bwd_variant(coords, consts[0], consts[3])
    if variant != "direct":
        raise AssertionError(f"encode_mlp_bwd took the {variant} variant at T = {big.capacity}")
    err, w_err = check_encode_mlp_bwd(torch, permuto_cuda, big_args)
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_bwd(*big_args),
                     lambda: permuto_cuda.encode_mlp_bwd_plain(*big_args), plain_window=True)
    bound_ms, bound_by = mlp_bwd_bound(args, big.capacity)
    phase("kernel_variant", name="encode_mlp_bwd", variant=variant,
          device_kernels=list(MLP_BWD_DEVICE_KERNELS["direct"]),
          case=f"histogram above the staged maximum (log2_hashmap_size 14, T = {big.capacity})",
          tolerance=MLP_BWD_TOLERANCE,
          max_abs_err=err, weight_rel_err=w_err,
          shape={"fields": coords.shape[0], "points": coords.shape[-1], "table": big.capacity},
          **timing, bound_ms=bound_ms, bound_by=bound_by)


def mlp_bwd_bound(args, t: int):
    """(least ms, what bounds it) of encode_mlp_bwd: coordinates, residual,
    head cotangent and weights in, the (B, 2, L, T) table gradient and the
    weight gradients out; the recomputed pre-activations, dh, dw1, dw0, dL/df
    and the lattice and its adds a point and level."""
    coords, feats, g, w0 = args[:4]
    b, p = coords.shape[0], coords.shape[-1]
    d, h = w0.shape[-2:]
    o = g.shape[-2]
    n_levels = d // 2
    weight_bytes = (d * h + h + h * o + o) * b * 4
    stream = b * p * (3 + d + o) * 4
    table_bytes = b * 2 * n_levels * t * 4
    return bound(table_bytes + 2 * weight_bytes + stream,
                 b * p * (n_levels * (LATTICE_OPS + 16) + 6 * d * h + 4 * h * o))


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


def check_iteration_against_cpu(torch, engine, ngm, against_unfused=False):
    """One optimization iteration at production width on the card and on
    the CPU (plain versions), from the same state and the same draws ->
    (worst relative loss difference, losses). With ``against_unfused`` (a
    fused-route map) the same iteration also runs on the card through the
    unfused route -> (worst vs CPU, worst vs unfused, losses)."""
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
    if against_unfused:
        unfused_fset = copy.deepcopy(ngm._fset)
        unfused_fset.prototype.fused_mlp = False
        worst_unfused = compare_losses(gpu, run(unfused_fset, clone(state), draws), "unfused")
    cpu_fset = copy.deepcopy(ngm._fset).to("cpu")
    worst = compare_losses(gpu, run(cpu_fset, to_cpu(state), to_cpu(draws)), "cpu")
    losses = {k: v.item() for k, v in gpu.items()}
    if against_unfused:
        return worst, worst_unfused, losses
    return worst, losses


def check_captured_encode_bwd_table(torch, permuto_cuda, args) -> dict:
    """Phase kernel_captured: encode_bwd_table at the inputs one training
    iteration of the 12-frame map gave it (samples that cluster on rays and
    surfaces, where the coarse levels' contention lives; the uniform draws
    of phase 3 spread them) against its plain version, timed -> the fields
    it adds to the kernel row."""
    coords, g, *consts = args
    consts = tuple(consts)
    err = check_encode_bwd_table(torch, permuto_cuda, coords, g, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_bwd_table(coords, g, *consts),
                     lambda: permuto_cuda.encode_bwd_table_plain(coords, g, *consts, max(consts[3])),
                     plain_window=True)
    n_levels = len(consts[0])
    bound_ms, bound_by = encode_bwd_table_bound(coords, g, n_levels, max(consts[3]))
    live = float(((g[:, 0::2] != 0) | (g[:, 1::2] != 0)).float().mean())
    variant = permuto_cuda.encode_bwd_table_variant(coords, consts[0], consts[3])
    phase("kernel_captured", name="encode_bwd_table", variant=variant,
          shape={"fields": coords.shape[0], "points": coords.shape[-1]},
          nonzero_cotangent_share=live, tolerance="max abs <= 1e-4 * max|plain|", max_abs_err=err,
          **timing, bound_ms=bound_ms, bound_by=bound_by)
    return {"captured_ms": timing["ms"], "captured_max_abs_err": err, "captured_bound_ms": bound_ms}


def check_captured_encode_fwd(torch, permuto_cuda, args) -> dict:
    """Phase kernel_captured: encode_fwd at the inputs one training
    iteration of the 12-frame map gave it (samples that cluster on rays and
    surfaces, so neighbouring points share corners) against its plain
    version, timed -> the fields it adds to the kernel row."""
    table, coords, *consts = args
    consts = tuple(consts)
    err = check_encode_fwd(torch, permuto_cuda, table, coords, consts)
    timing = measure(torch, lambda: permuto_cuda.encode_fwd(table, coords, *consts),
                     lambda: permuto_cuda.encode_fwd_plain(table, coords, *consts), plain_window=True)
    n_levels = table.shape[-2]
    n_bytes = (table.numel() + coords.numel() + coords.shape[0] * 2 * n_levels * coords.shape[-1]) * 4
    bound_ms, bound_by = bound(n_bytes, coords.shape[0] * coords.shape[-1] * n_levels * LATTICE_OPS)
    phase("kernel_captured", name="encode_fwd", variant=permuto_cuda.encode_fwd_variant(table),
          shape={"fields": coords.shape[0], "points": coords.shape[-1]},
          tolerance="max abs <= 1e-5", max_abs_err=err, **timing, bound_ms=bound_ms, bound_by=bound_by)
    return {"captured_ms": timing["ms"], "captured_max_abs_err": err, "captured_bound_ms": bound_ms}


def check_captured_encode_mlp_bwd(torch, permuto_cuda, call) -> dict:
    """Phase kernel_captured: encode_mlp_bwd at the inputs one fused
    training iteration of the 12-frame map gave it, against its plain
    version and timed -> the fields it adds to the kernel row. These inputs
    change from run to run, so the check takes the cotangent off the ReLU
    kink (:func:`off_the_relu_kink`): at a point on it the kernel and the
    plain matrix product may pick different masks, which moved a table
    gradient entry by 2.6e-3 against a 6.7e-4 limit in a card test. The
    error on the inputs as they were is reported beside it."""
    args = tuple(call[0])
    coords, consts = args[0], args[6:]
    kink_free, kink_points = off_the_relu_kink(torch, args)
    err, w_err = check_encode_mlp_bwd(torch, permuto_cuda, kink_free)
    as_given = max_err(torch, permuto_cuda.encode_mlp_bwd(*args)[0], permuto_cuda.encode_mlp_bwd_plain(*args)[0])
    timing = measure(torch, lambda: permuto_cuda.encode_mlp_bwd(*args),
                     lambda: permuto_cuda.encode_mlp_bwd_plain(*args), plain_window=True)
    bound_ms, bound_by = mlp_bwd_bound(args, max(consts[3]))
    phase("kernel_captured", name="encode_mlp_bwd",
          variant=permuto_cuda.encode_mlp_bwd_variant(coords, consts[0], consts[3]),
          shape={"fields": coords.shape[0], "points": coords.shape[-1]},
          tolerance=MLP_BWD_TOLERANCE + " (no cotangent at points on a ReLU kink)", kink_points=kink_points,
          max_abs_err=err, weight_rel_err=w_err, max_abs_err_as_given=as_given,
          **timing, bound_ms=bound_ms, bound_by=bound_by)
    return {"captured_ms": timing["ms"], "captured_max_abs_err": err, "captured_bound_ms": bound_ms}


def compare_losses(gpu, other, name: str) -> float:
    """Worst relative difference of two loss dicts; raises above 1e-3."""
    worst = 0.0
    for k, v in gpu.items():
        a, b = v.item(), other[k].item()
        if not (math.isfinite(a) and math.isfinite(b)):
            raise AssertionError(f"non-finite loss {k}: gpu {a}, {name} {b}")
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if rel > 1e-3:
            raise AssertionError(f"loss {k}: gpu {a} vs {name} {b} (rel {rel:.2e} > 1e-3)")
    return worst


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


def profile_slice(torch, engine, ds, frames, steady_ms, out_path: pathlib.Path,
                  config=None, name: str = "profile") -> None:
    """--profile: torch.profiler over the steady frames of a fresh map
    (``config``, CONFIG by default)."""
    ngm = engine.NeuralGraphMap(config or CONFIG, device="cuda")
    for fid in range(STEADY_FROM + 1):
        ngm.process_frame(ds, fid, frames[fid])
    later = frames[STEADY_FROM + 1:]

    def run():
        for fid, rgbd in enumerate(later, start=STEADY_FROM + 1):
            ngm.process_frame(ds, fid, rgbd)

    prof, wall_ms, events, busy_ms = profiled(torch, run)
    n = len(later)
    phase(
        name, frames=[STEADY_FROM + 2, NUM_FRAMES], device_events=events,
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
    return capture_calls(module, (name,), fn)[name]


def capture_calls(module, names, fn):
    """Run fn() with each ``module.name`` wrapped -> {name: (args, kwargs)
    of its first call}."""
    origs = {name: getattr(module, name) for name in names}
    seen = {}

    def spy_for(name):
        def spy(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return origs[name](*args, **kwargs)
        return spy

    for name in names:
        setattr(module, name, spy_for(name))
    try:
        fn()
    finally:
        for name, orig in origs.items():
            setattr(module, name, orig)
    missing = [name for name in names if name not in seen]
    if missing:
        raise AssertionError(f"{missing} not called")
    return seen


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


def field_runs(torch, tile_experts, live: int) -> dict:
    """The live tiles' runs of one field (the dispatch sorts tiles by
    field): their count and their mean, shortest and longest length in
    tiles."""
    _, lengths = torch.unique_consecutive(tile_experts[:live], return_counts=True)
    return {"field_runs": int(lengths.numel()), "mean_run_tiles": live / int(lengths.numel()),
            "min_run_tiles": int(lengths.min()), "max_run_tiles": int(lengths.max())}


def check_render_kernels(torch, engine, permuto_cuda, topk, dispatch, ngm, ds):
    """Phase 5: the render kernels against their plain versions at the
    shapes of the first 8192-ray block of the trained map's 160x120 render.
    Each MoE encode's line also gives the block's live pairs (its valid
    (sample, field) pairs, counted from the dispatch's arguments) and its
    field runs (:func:`field_runs`), and names its device kernel;
    ``topk2_fields``' line gives the share of (point, centre) pairs it
    evaluated (:func:`topk_evaluated_pairs`). Then the
    ``kernel_variant`` lines: ``topk2_fields`` at 1,024 centres, both MoE
    encodes at T = 16,384, and the carried encode with a field change at
    every tile."""
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
    (_, pair_valid, *_), _ = capture_call(
        dispatch, "tiled_dispatch_sorted", lambda: engine.render_block_tiled(*args, use_ray_kernel=True, **kw))
    live_pairs = int(pair_valid.sum())
    moe_args, moe_kw = capture_call(
        permuto_cuda, "encode_fwd_moe",
        lambda: engine.render_block_tiled(*args, use_ray_kernel=False, **kw))
    rows, shapes, bounds = [], {}, {}

    # topk2_fields: bit-identical on every point
    check_topk(torch, topk, pts, cen, valid)
    n_pts, n_cen, n_valid = pts.shape[1], cen.shape[0], int(valid.sum())
    rows.append(("topk2_fields", 0.0, "exact (distances and indices)",
                 measure(torch, lambda: topk.topk2_fields(pts, cen, valid),
                         lambda: topk.topk2_fields_plain(pts, cen, valid), plain_window=True)))
    evaluated = topk_evaluated_pairs(torch, topk, pts, cen, valid)
    rows[-1][3].update(pairs_evaluated_share=evaluated / (n_pts * n_cen))
    shapes["topk2_fields"] = {"points": n_pts, "centres": n_cen, "valid_centres": n_valid,
                              "box_points": topk.BOX_POINTS}
    bounds["topk2_fields"] = topk_bound(n_pts, n_cen, evaluated)
    check_topk_many_centres(torch, topk, pts, cen, valid)

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
        err = check_moe(torch, permuto_cuda, name, c_args, c_kw, sel)
        rows.append((name, err, f"max abs <= 1e-5 on {sel.numel()} live tiles",
                     measure(torch, lambda: kernel(*c_args, **c_kw),
                             lambda: plain(*c_args, **c_kw), plain_window=True)))
        te = c_args[3] if name == "encode_fwd_moe_rays" else c_args[2]
        experts = int(torch.unique(te[:live]).numel())
        pairs = live * permuto_cuda.TILE
        bounds[name] = moe_bound(name, pairs, experts, levels, tables.shape[3])
        shapes[name] = {"tiles": n_tiles, "live_tiles": live, "pairs": pts.shape[1] * 2,
                        "live_pairs": live_pairs, "live_fields": experts, **field_runs(torch, te, live)}
        rows[-1][3].update(device_kernels=[MOE_DEVICE_KERNELS[name]])
        check_moe_big_tables(torch, permuto_cuda, name, ngm._fset.prototype.encoding, c_args, c_kw, sel,
                             gen, shapes[name])
        if name == "encode_fwd_moe":
            check_moe_field_changes(torch, permuto_cuda, c_args, c_kw, sel, shapes[name])
    return report_rows(rows, shapes, bounds)


def check_topk(torch, topk, pts, cen, valid) -> None:
    """topk2_fields against its plain version: distances and indices
    bit-identical on every point, or raise."""
    d, i = topk.topk2_fields(pts, cen, valid)
    wd, wi = topk.topk2_fields_plain(pts, cen, valid)
    finite = torch.isfinite(wd)
    if not (torch.equal(i, wi) and torch.equal(torch.isfinite(d), finite)
            and torch.equal(d[finite], wd[finite])):
        raise AssertionError(f"topk2_fields differs from its plain version at {cen.shape[0]} centres")


def topk_bound(n_pts: int, n_cen: int, evaluated: int):
    """topk2_fields' least time: points + centres (xyz, valid) in, 2
    distances + 2 indices out; 8 f32 operations for each (point, centre)
    pair the kernel evaluated (``evaluated``, measured), not for every
    pair: the pairs its pruning drops need no operation."""
    return bound(n_pts * 12 + n_cen * 13 + n_pts * 16, evaluated * 8)


def topk_evaluated_pairs(torch, topk, pts, cen, valid) -> int:
    """The (point, centre) pairs topk2_fields evaluated: each box's
    surviving centres, counted by the kernel (topk.topk2_box_survivors),
    times the box's points. Raises unless every box kept exactly the
    centres the plain model of the pruning rule (topk2_survivors_plain)
    keeps."""
    counts = topk.topk2_box_survivors(pts, cen, valid)
    want = topk.topk2_survivors_plain(pts, cen, valid).sum(1, dtype=torch.int32)
    if not torch.equal(counts, want):
        bad = int((counts != want).sum())
        raise AssertionError(f"topk2_fields' pruning kept other counts than its plain model in {bad} "
                             f"of {counts.numel()} boxes at {cen.shape[0]} centres")
    per_box = torch.full_like(counts, topk.BOX_POINTS)
    per_box[-1] = pts.shape[1] - (counts.numel() - 1) * topk.BOX_POINTS
    return int((counts.long() * per_box).sum())


MANY_CENTRES = 1024


def check_topk_many_centres(torch, topk, pts, cen, valid) -> None:
    """Phase kernel_variant: topk2_fields on the render block's points
    against a map grown to MANY_CENTRES fields, as benchmarks/scale_sweep.py
    grows one: the map's centre slots, then seeded centres uniform in the
    valid centres' bounding box widened by 1 m, all valid. Exact against
    the plain version, with the share of pairs evaluated, timed."""
    dev = pts.device
    gen = torch.Generator(dev).manual_seed(1024)
    lo = cen[valid].amin(0) - 1.0
    hi = cen[valid].amax(0) + 1.0
    extra = lo + (hi - lo) * torch.rand((MANY_CENTRES - cen.shape[0], 3), generator=gen, device=dev)
    many = torch.cat([cen, extra]).contiguous()
    many_valid = torch.cat([valid, torch.ones(extra.shape[0], dtype=torch.bool, device=dev)])
    check_topk(torch, topk, pts, many, many_valid)
    timing = measure(torch, lambda: topk.topk2_fields(pts, many, many_valid),
                     lambda: topk.topk2_fields_plain(pts, many, many_valid), plain_window=True)
    n_valid = int(many_valid.sum())
    evaluated = topk_evaluated_pairs(torch, topk, pts, many, many_valid)
    bound_ms, bound_by = topk_bound(pts.shape[1], MANY_CENTRES, evaluated)
    phase("kernel_variant", name="topk2_fields", case=f"{MANY_CENTRES} centres (the map's "
          f"{cen.shape[0]} slots and {extra.shape[0]} uniform in its box + 1 m)",
          tolerance="exact (distances and indices)", max_abs_err=0.0,
          shape={"points": pts.shape[1], "centres": MANY_CENTRES, "valid_centres": n_valid,
                 "box_points": topk.BOX_POINTS},
          pairs_evaluated_share=evaluated / (pts.shape[1] * MANY_CENTRES), **timing,
          bound_ms=bound_ms, bound_by=bound_by)


# The device kernel of each MoE encode: one body, by point source.
MOE_DEVICE_KERNELS = {"encode_fwd_moe": "encode_fwd_moe_kernel<CarriedPoints>",
                      "encode_fwd_moe_rays": "encode_fwd_moe_kernel<RayPoints>"}


def check_moe(torch, permuto_cuda, name: str, args, kw, sel) -> float:
    """A MoE encode (``name``) on a render block's inputs against its plain
    version on the live tiles ``sel`` -> max abs error; raises above 1e-5."""
    full = getattr(permuto_cuda, name)(*args, **kw)
    per_tile = (1, 2, 3) if name == "encode_fwd_moe_rays" else (1, 2)  # tile-major inputs
    sub_args = tuple(a[sel].contiguous() if j in per_tile else a for j, a in enumerate(args))
    sub_kw = {k: v for k, v in kw.items() if k != "num_live_tiles"}
    ref = getattr(permuto_cuda, name + "_plain")(*sub_args, **sub_kw)
    err = float((full[sel] - ref).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name} max abs err {err} > 1e-5 on {sel.numel()} live tiles")
    return err


def moe_bound(name: str, pairs: int, experts: int, levels: int, t: int):
    """(least ms, what bounds it) of a MoE encode over ``pairs`` pairs of
    live tiles: their inputs (an index and a distance, or xyz) and the
    fields' tables in, the features out; the lattice (and the ray rebuild)."""
    rays = name == "encode_fwd_moe_rays"
    return bound(pairs * (8 if rays else 12) + experts * 2 * levels * t * 4 + pairs * 2 * levels * 4,
                 pairs * (levels * LATTICE_OPS + (40 if rays else 0)))


def check_moe_big_tables(torch, permuto_cuda, name: str, enc, args, kw, sel, gen, shape) -> None:
    """Phase kernel_variant: a MoE encode on the render block's inputs with
    tables of log2_hashmap_size 14 (T = 16,384, rows four times the
    production's: more of the corners miss L1), against its plain version
    on the same live tiles, timed."""
    big, consts = big_table_consts(enc)
    tables = torch.rand(args[0].shape[:3] + (big.capacity,), generator=gen, device=args[0].device) * 2 - 1
    consts_at = 7 if name == "encode_fwd_moe_rays" else 3  # scales, shifts, elev, t_size
    big_args = (tables,) + tuple(args[1:consts_at]) + consts
    err = check_moe(torch, permuto_cuda, name, big_args, kw, sel)
    timing = measure(torch, lambda: getattr(permuto_cuda, name)(*big_args, **kw),
                     lambda: getattr(permuto_cuda, name + "_plain")(*big_args, **kw), plain_window=True)
    pairs = shape["live_tiles"] * permuto_cuda.TILE
    bound_ms, bound_by = moe_bound(name, pairs, shape["live_fields"], big.nr_levels, big.capacity)
    phase("kernel_variant", name=name, device_kernels=[MOE_DEVICE_KERNELS[name]],
          case=f"tables of log2_hashmap_size 14 (T = {big.capacity})",
          tolerance=f"max abs <= 1e-5 on {sel.numel()} live tiles", max_abs_err=err,
          shape=dict(shape, table=big.capacity), **timing,
          bound_ms=bound_ms, bound_by=bound_by)


def check_moe_field_changes(torch, permuto_cuda, args, kw, sel, shape) -> None:
    """Phase kernel_variant: the carried encode with every live tile owned
    by another field than the tile before it (the render block's live
    fields in turn), so an SM's two tiles never share a table. The
    dispatch sorts tiles by field, so runs this short come only from fields
    with fewer than 1,024 pairs. Against its plain version on the same live
    tiles, timed."""
    te = args[2]
    live = shape["live_tiles"]
    fields = torch.unique(te[:live])
    turns = fields[torch.arange(te.shape[0], device=te.device) % fields.numel()].to(torch.int32)
    r_args = (args[0], args[1], turns.contiguous()) + tuple(args[3:])
    err = check_moe(torch, permuto_cuda, "encode_fwd_moe", r_args, kw, sel)
    timing = measure(torch, lambda: permuto_cuda.encode_fwd_moe(*r_args, **kw),
                     lambda: permuto_cuda.encode_fwd_moe_plain(*r_args, **kw), plain_window=True)
    bound_ms, bound_by = moe_bound("encode_fwd_moe", live * permuto_cuda.TILE, int(fields.numel()),
                                   args[0].shape[2], args[0].shape[3])
    phase("kernel_variant", name="encode_fwd_moe", device_kernels=[MOE_DEVICE_KERNELS["encode_fwd_moe"]],
          case="a field change at every tile",
          tolerance=f"max abs <= 1e-5 on {sel.numel()} live tiles", max_abs_err=err,
          shape=dict(shape, field_runs=live, mean_run_tiles=1.0, min_run_tiles=1, max_run_tiles=1),
          **timing, bound_ms=bound_ms, bound_by=bound_by)


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


def check_render_carried(torch, permuto_cuda, topk, ngm, ds, smi):
    """Phase 7: the carried-coordinate route, as eval_span_samples: 768 with
    eval_num_samples: 768 (the quality recipe) set it, at 160x120: launches
    and median ms of 5 renders -> launches."""
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
        ms, all_ms = timed_renders(torch, ngm, ds[RENDER_FRAME]["c2w"], ds.camera, 5)
    finally:
        ngm._eval_span_samples = saved
    if launches != {"topk2_fields": blocks, "encode_fwd_moe_rays": 0, "encode_fwd_moe": blocks}:
        raise AssertionError(f"carried route launches {launches}, expected {blocks} blocks")
    if not bool(torch.isfinite(rgbd).all()):
        raise AssertionError("carried route render is not finite")
    phase("render_carried", span_samples=768, rays_per_block=block, blocks=blocks, launches=launches,
          median_ms_per_image=ms, ms=all_ms, card=smi)
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


def run_frames(torch, ngm, ds, frames):
    """process_frame over ``frames`` -> (trained frames, seconds a frame,
    the trained frames' loss dicts)."""
    trained, frame_s, all_losses = 0, [], []
    for fid, rgbd in enumerate(frames):
        t0 = time.perf_counter()
        losses = ngm.process_frame(ds, fid, rgbd)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if losses:
            trained += 1
            all_losses.append(losses)
    if ngm.num_fields < CONFIG["num_train_fields"]:
        raise AssertionError(f"only {ngm.num_fields} fields allocated")
    bad = [(i, k, v) for i, d in enumerate(all_losses) for k, v in d.items() if not math.isfinite(v)]
    if bad or not all_losses:
        raise AssertionError(f"non-finite or missing losses: {bad[:5]}")
    return trained, frame_s, all_losses


def check_fused_slice(torch, engine, permuto_cuda, ds, frames, unfused, smi):
    """Phase slice_fused_mlp: a fresh map with ``fused_mlp: true`` over the
    same frames; every iteration through encode_mlp_fwd / encode_mlp_bwd and
    never the unfused encodes; steady ms a frame beside the unfused slice's
    (``unfused``: its median and mean); then one production-width iteration
    against the CPU and against the unfused route on the card -> (launches,
    steady mean ms a frame, {name: (args, kwargs)} of that iteration's
    encode_mlp_fwd and encode_mlp_bwd calls on the card)."""
    ngm = engine.NeuralGraphMap(dict(CONFIG, fused_mlp=True), device="cuda")
    torch.cuda.synchronize()
    permuto_cuda.reset_launch_counts()
    trained, frame_s, all_losses = run_frames(torch, ngm, ds, frames)
    names = ("encode_mlp_fwd", "encode_mlp_bwd", "encode_fwd", "encode_bwd_table")
    launches = {k: permuto_cuda.LAUNCHES[k] for k in names}
    want = CONFIG["num_iterations_per_frame"] * trained
    if launches != {"encode_mlp_fwd": want, "encode_mlp_bwd": want, "encode_fwd": 0, "encode_bwd_table": 0}:
        raise AssertionError(f"fused slice launches {launches}, expected {want} fused and 0 unfused")
    steady = frame_s[STEADY_FROM:]
    phase(
        "slice_fused_mlp", frames=NUM_FRAMES, trained_frames=trained, fields=ngm.num_fields,
        launches=launches, frame_ms=[round(x * 1e3, 3) for x in frame_s],
        steady_ms_per_frame_median=statistics.median(steady) * 1e3,
        steady_ms_per_frame_mean=statistics.mean(steady) * 1e3,
        unfused_steady_ms_per_frame_median=unfused[0], unfused_steady_ms_per_frame_mean=unfused[1],
        last_losses=all_losses[-1], card=smi,
    )
    results = []
    calls = capture_calls(permuto_cuda, ("encode_mlp_fwd", "encode_mlp_bwd"), lambda: results.append(
        check_iteration_against_cpu(torch, engine, ngm, against_unfused=True)))
    worst_cpu, worst_unfused, losses = results[0]
    phase("fused_iteration_vs_cpu", max_rel_diff_cpu=worst_cpu, max_rel_diff_unfused_card=worst_unfused,
          tolerance="rel <= 1e-3", losses=losses)
    return {k: launches[k] for k in names[:2]}, statistics.mean(steady) * 1e3, calls


def ab_training_routes(torch, engine, ds, frames, rounds: int, smi) -> None:
    """--ab: steady median ms a frame of fresh maps on the two training
    routes in turns (unfused, fused, fused, unfused) x rounds, one process,
    one card; pairs are (first unfused, first fused) and (second, second)
    of each round."""
    configs = {"unfused": CONFIG, "fused": dict(CONFIG, fused_mlp=True)}
    runs = {"unfused": [], "fused": []}
    for _ in range(rounds):
        for name in ("unfused", "fused", "fused", "unfused"):
            ngm = engine.NeuralGraphMap(configs[name], device="cuda")
            frame_s = run_frames(torch, ngm, ds, frames)[1]
            runs[name].append(statistics.median(frame_s[STEADY_FROM:]) * 1e3)
    firsts = {k: v[0::2] for k, v in runs.items()}
    seconds = {"unfused": runs["unfused"][1::2], "fused": runs["fused"][1::2]}
    pairs = list(zip(firsts["unfused"], firsts["fused"])) + list(zip(seconds["unfused"], seconds["fused"]))
    phase(
        "ab_training_routes", rounds=rounds, order="unfused, fused, fused, unfused",
        steady_median_ms=runs, pairs=len(pairs), fused_faster_in=sum(f < u for u, f in pairs),
        median_unfused=statistics.median(runs["unfused"]), median_fused=statistics.median(runs["fused"]),
        quartiles_unfused=statistics.quantiles(runs["unfused"], n=4),
        quartiles_fused=statistics.quantiles(runs["fused"], n=4), card=smi,
    )


def field2d_kwargs():
    """A 2D permutohedral field set at the production encoding widths
    (L = 16, T = 2^12, 2 features a level), one hidden layer, 3 outputs."""
    model = CONFIG["model_kwargs"]
    field = dict(model["field_kwargs"], dim_out=3, neus_initial_sd=None)
    field["encoding_kwargs"] = dict(field["encoding_kwargs"], pos_dim=2)
    return dict(model, dim_points=2, field_kwargs=field)


def check_gather_pairs_direct(torch, permuto_cuda, gen, table, idx) -> None:
    """Phases kernel_variant: gather_pairs' direct variant, exact against its
    plain version and timed as the rows are, (1) at the 2D field set's shape
    with the table 4 bytes off 16-byte alignment (the bulk copy cannot take
    it), the design the kernel had before it staged tables, and (2) at a
    table above the staged maximum (32 rows, T = 16,384, 128 KB a row)."""
    dev = torch.device("cuda")
    off = torch.empty(table.numel() + 1, device=dev)[1:].view(table.shape)
    off.copy_(table)
    big_t = 16384
    big = torch.rand((32, 2, big_t), generator=gen, device=dev) * 2 - 1
    big_idx = torch.randint(0, big_t, (32, idx.shape[-1]), generator=gen, device=dev)
    for case, tab, ids in (("unaligned table", off, idx), ("table above the staged maximum", big, big_idx)):
        variant = permuto_cuda.gather_pairs_variant(tab, ids)
        if variant != "direct":
            raise AssertionError(f"gather_pairs took the {variant} variant for the {case}")
        if not torch.equal(permuto_cuda.gather_pairs(tab, ids), permuto_cuda.gather_pairs_plain(tab, ids)):
            raise AssertionError(f"gather_pairs (direct variant, {case}) differs from torch.gather")
        ids_full = ids.unsqueeze(-2).expand(ids.shape[:-1] + (2, ids.shape[-1]))
        timing = measure(torch, lambda: permuto_cuda.gather_pairs(tab, ids),
                         lambda: permuto_cuda.gather_pairs_plain(tab, ids),
                         library=lambda: torch.gather(tab, -1, ids_full))
        bound_ms, bound_by = bound(tab.numel() * 4 + ids.numel() * (8 + 2 * 4), 0)
        phase("kernel_variant", name="gather_pairs", variant=variant, case=case, tolerance="exact",
              max_abs_err=0.0, shape={"rows": int(ids.shape[:-1].numel()), "pairs_per_row": ids.shape[-1],
                                      "table": tab.shape[-1]},
              **timing, bound_ms=bound_ms, bound_by=bound_by)


def check_table_grad(torch, permuto_cuda, idx, gv, t: int) -> float:
    """table_grad against its plain version -> max abs error; raises above
    1e-4 * max|plain| (atomics change the summation order)."""
    got = permuto_cuda.table_grad(idx, gv, t)
    ref = permuto_cuda.table_grad_plain(idx, gv, t)
    err = max_err(torch, got, ref)
    if not err <= 1e-4 * float(ref.abs().max()):
        raise AssertionError(f"table_grad max abs err {err} > 1e-4 * max|plain|")
    return err


def index_add_call(torch, idx, gv, t: int):
    """The one PyTorch call that computes table_grad's function on these
    inputs: index_add_ into a flat (rows * 2 * T) histogram."""
    n_rows = gv.shape[:-1].numel()
    flat = (torch.arange(n_rows, device=gv.device).reshape(gv.shape[:-1] + (1,)) * t
            + idx.unsqueeze(-2)).reshape(-1)
    gvf = gv.reshape(-1)
    hist = torch.zeros(n_rows * t, device=gv.device)
    return lambda: hist.index_add_(0, flat, gvf)


def table_grad_bound(idx, t: int):
    """(least ms, what bounds it) of table_grad: indices and two values a
    pair in, the (rows, 2, T) histogram out; two adds a pair."""
    pairs, rows = idx.numel(), idx.shape[:-1].numel()
    return bound(pairs * (8 + 2 * 4) + rows * 2 * t * 4, 2 * pairs)


def check_table_grad_variants(torch, permuto_cuda, gen, idx, gv, t: int) -> None:
    """Phases kernel_variant: table_grad (1) at the 2D field set's inputs
    with the values 4 bytes off 16-byte alignment (the staged kernel with
    scalar loads) and (2) with a table above the staged maximum (32 rows of
    the set's pair count, T = 16,384: the direct variant, global atomics),
    each against its plain version and timed beside index_add_."""
    dev = gv.device
    off = torch.empty(gv.numel() + 1, device=dev)[1:].view(gv.shape)
    off.copy_(gv)
    big_t, m = 16384, idx.shape[-1]
    big_idx = torch.randint(0, big_t, (32, m), generator=gen, device=dev)
    big_gv = torch.randn((32, 2, m), generator=gen, device=dev)
    for case, ii, vv, tt, want in (
        ("values 4 bytes off 16-byte alignment (scalar loads)", idx, off, t, "staged"),
        ("table above the staged maximum", big_idx, big_gv, big_t, "direct"),
    ):
        variant = permuto_cuda.table_grad_variant(ii, vv, tt)
        if variant != want:
            raise AssertionError(f"table_grad took the {variant} variant for the {case}")
        err = check_table_grad(torch, permuto_cuda, ii, vv, tt)
        timing = measure(torch, lambda: permuto_cuda.table_grad(ii, vv, tt),
                         lambda: permuto_cuda.table_grad_plain(ii, vv, tt),
                         library=index_add_call(torch, ii, vv, tt))
        bound_ms, bound_by = table_grad_bound(ii, tt)
        phase("kernel_variant", name="table_grad", variant=variant, case=case,
              tolerance="max abs <= 1e-4 * max|plain|", max_abs_err=err,
              shape={"rows": int(ii.shape[:-1].numel()), "pairs_per_row": m, "table": tt},
              **timing, bound_ms=bound_ms, bound_by=bound_by)


def check_field2d(torch, permuto_cuda, optimizer, NeuralFieldSet, smi):
    """Phases kernel (gather_pairs, table_grad) and field2d: a 2D field set
    of 32 fields x 12,288 points through apply_vmap (the gather route), its
    forward and backward on the card against the CPU, the two kernels
    against their plain versions at the captured shapes, and five Adam
    steps of a fit to a smooth target -> (launches, kernel rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2024)
    fset = NeuralFieldSet(**field2d_kwargs()).to(dev)
    n, p = 32, 512 * 24
    params = fset.init_fields(n, gen, dev)
    params["enc.table"] = torch.rand(params["enc.table"].shape, generator=gen, device=dev) * 2 - 1
    theta = torch.rand((n,), generator=gen, device=dev) * 2 * math.pi
    ori = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    pos = torch.randn((n, 2), generator=gen, device=dev)
    pts = pos[:, None, :] + torch.rand((n, p, 2), generator=gen, device=dev) * 2 - 1
    x, y = pts.unbind(-1)
    target = 0.5 * torch.stack([torch.sin(2 * x) * torch.cos(y), torch.cos(3 * y), torch.sin(x + y)], -1)

    def loss_and_grads(fs, prm, points, po, oo, tgt):
        leaves = {k: v.detach().requires_grad_(True) for k, v in prm.items()}
        out = fs.apply_vmap(leaves, points, po, oo)
        loss = torch.mean((out - tgt) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return out.detach(), loss.detach(), dict(zip(leaves, grads))

    first = []
    calls = capture_calls(permuto_cuda, ("gather_pairs", "table_grad"),
                          lambda: first.append(loss_and_grads(fset, params, pts, pos, ori, target)))
    out, _, grads = first[0]
    cpu = loss_and_grads(copy.deepcopy(fset).to("cpu"), *to_cpu((params, pts, pos, ori, target)))
    out_err = max_err(torch, out.cpu(), cpu[0])
    grad_errs = {k: max_err(torch, g.cpu(), cpu[2][k], relative=True) for k, g in grads.items()}
    if not (out_err <= 1e-5 and max(grad_errs.values()) <= 1e-4):
        raise AssertionError(f"2D field set card vs CPU: outputs {out_err}, gradients {grad_errs}")

    # kernels 7-8 at the captured shapes
    (table, idx), _ = calls["gather_pairs"]
    (t_idx, gv, t_size), _ = calls["table_grad"]
    got = permuto_cuda.gather_pairs(table, idx)
    if not torch.equal(got, permuto_cuda.gather_pairs_plain(table, idx)):
        raise AssertionError("gather_pairs differs from torch.gather")
    variant = permuto_cuda.gather_pairs_variant(table, idx)
    if variant != "staged":
        raise AssertionError(f"gather_pairs took the {variant} variant at T = {t_size}")
    tg_err = check_table_grad(torch, permuto_cuda, t_idx, gv, t_size)
    idx_full = idx.unsqueeze(-2).expand(idx.shape[:-1] + (2, idx.shape[-1]))
    tg_timing = measure(torch, lambda: permuto_cuda.table_grad(t_idx, gv, t_size),
                        lambda: permuto_cuda.table_grad_plain(t_idx, gv, t_size),
                        library=index_add_call(torch, t_idx, gv, t_size))
    tg_timing.update(variant=permuto_cuda.table_grad_variant(t_idx, gv, t_size))
    rows = [
        ("gather_pairs", 0.0, "exact",
         measure(torch, lambda: permuto_cuda.gather_pairs(table, idx),
                 lambda: permuto_cuda.gather_pairs_plain(table, idx),
                 library=lambda: torch.gather(table, -1, idx_full))),
        ("table_grad", tg_err, "max abs <= 1e-4 * max|plain| (atomics)", tg_timing),
    ]
    f32, pairs = 4, idx.numel()
    bounds = {
        # indices in, both features of every pair out, the tables read once
        "gather_pairs": bound(table.numel() * f32 + pairs * (8 + 2 * f32), 0),
        "table_grad": table_grad_bound(t_idx, t_size),
    }
    shapes = {name: {"rows": int(idx.shape[:-1].numel()), "pairs_per_row": idx.shape[-1],
                     "table": t_size} for name in bounds}
    rows[0][3]["variant"] = variant
    kernel_rows = report_rows(rows, shapes, bounds)
    check_gather_pairs_direct(torch, permuto_cuda, gen, table, idx)
    check_table_grad_variants(torch, permuto_cuda, gen, t_idx, gv, t_size)

    # five Adam steps of the fit, on the card
    fit = clone(params)
    adam = optimizer.init_adam_state(fit)
    ids = torch.arange(n, device=dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    cfg = optimizer.AdamConfig(learning_rate=1e-2)
    permuto_cuda.reset_launch_counts()
    losses = []
    for _ in range(5):
        sub = {k: v.index_select(0, ids) for k, v in fit.items()}
        _, loss, step_grads = loss_and_grads(fset, sub, pts, pos, ori, target)
        losses.append(loss)
        optimizer.adam_slice_update(cfg, fit, adam, ids, valid, step_grads, sub)
    torch.cuda.synchronize()
    launches = {k: permuto_cuda.LAUNCHES[k] for k in ("gather_pairs", "table_grad")}
    with torch.no_grad():
        final = torch.mean((fset.apply_vmap(fit, pts, pos, ori) - target) ** 2).item()
    losses = [v.item() for v in losses] + [final]
    if not (all(math.isfinite(v) for v in losses) and final < losses[0]):
        raise AssertionError(f"the 2D fit did not lower its loss: {losses}")
    if min(launches.values()) < 5:
        raise AssertionError(f"gather-route launches {launches} over 5 steps, expected >= 1 a step")
    phase("field2d", fields=n, points=p, levels=fset.prototype.encoding.nr_levels,
          table=fset.prototype.encoding.capacity, max_abs_out_vs_cpu=out_err,
          max_rel_grad_vs_cpu=max(grad_errs.values()),
          tolerance="outputs max abs <= 1e-5; gradients <= 1e-4 * max|cpu|",
          fit_losses=losses, launches_5_steps=launches, card=smi)
    return launches, kernel_rows


def check_geometry_gradients(torch, permuto_cuda, losses, ngm):
    """Phase geometry_gradients: one field of the trained map at 4,096
    field-local points, on the card against the CPU."""
    dev = torch.device("cuda")
    trained = ngm._map_arrays.training_iterations[: ngm.num_fields]
    fid = int(torch.argmax(trained))
    params = {k: v[fid] for k, v in ngm._params.items()}
    pts = torch.rand((4096, 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
    field = ngm._fset.prototype
    permuto_cuda.reset_launch_counts()
    grads = field.geometry_gradients(params, pts)
    torch.cuda.synchronize()
    launches = permuto_cuda.LAUNCHES["gather_pairs"]
    want = copy.deepcopy(field).to("cpu").geometry_gradients(to_cpu(params), pts.cpu())
    err = max_err(torch, grads.cpu(), want, relative=True)
    peak = float(want.abs().max())
    eikonal = losses.eikonal_term(grads).item()
    if not (err <= 1e-4 and peak > 0.0 and launches >= 1 and math.isfinite(eikonal)):
        raise AssertionError(f"geometry_gradients: rel err {err}, max |grad| {peak}, "
                             f"gather_pairs launches {launches}, eikonal {eikonal}")
    phase("geometry_gradients", field=fid, training_iterations=int(trained[fid]), points=4096,
          max_rel_err_vs_cpu=err, tolerance="max abs <= 1e-4 * max|cpu|", max_abs_grad=peak,
          eikonal=eikonal, gather_pairs_launches=launches)



def all_launches(permuto_cuda, topk):
    return {**permuto_cuda.LAUNCHES, **topk.LAUNCHES}


def check_cli(torch, permuto_cuda, topk, run_mapping, out_dir: pathlib.Path, smi):
    """Phase cli: the port's CLI runner on the card at config/synthetic.yaml's
    own settings (60 frames; held-out renders; mesh at 0.04 m; a full
    checkpoint) -> (runner, the run's launches, meshing's launches, checkpoint)."""
    import numpy as np

    cfg = dict(CONFIG, out_dir=str(out_dir), checkpoint_full=True, eval_store_details=False,
               render_vis=False, host_prefetch_depth=2)
    runner = run_mapping.NeuralGraphMapRunner(cfg, device="cuda")
    extract = runner.extract_mesh
    meshing = {}

    def counted_extract_mesh(*args, **kwargs):
        torch.cuda.synchronize()
        before = all_launches(permuto_cuda, topk)
        t0 = time.perf_counter()
        mesh = extract(*args, **kwargs)
        torch.cuda.synchronize()
        meshing["seconds"] = time.perf_counter() - t0
        meshing["launches"] = {k: v - before[k] for k, v in all_launches(permuto_cuda, topk).items()}
        meshing["mesh"] = mesh
        return mesh

    runner.extract_mesh = counted_extract_mesh
    save = runner.save_model

    def timed_save_model(*args, **kwargs):
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        meshing["save_s"] = time.perf_counter() - t0
        return path

    runner.save_model = timed_save_model
    torch.cuda.synchronize()
    permuto_cuda.reset_launch_counts()
    topk.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = runner.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = all_launches(permuto_cuda, topk)

    mesh = meshing.get("mesh")
    mesh_launches = meshing.get("launches", {})
    ckpts = list(runner._out_dir.glob("*.npz"))
    want = ["online_psnr", "online_depthl1", "final_psnr", "final_depthl1", "fps_estimate", "spf_estimate"]
    bad = [k for k in want if not math.isfinite(metrics.get(k, math.nan))]
    if bad or runner.engine.num_fields < CONFIG["num_train_fields"]:
        raise AssertionError(f"cli: non-finite or missing metrics {bad}, {runner.engine.num_fields} fields")
    if mesh is None or len(mesh.vertices) == 0 or len(mesh.faces) == 0:
        raise AssertionError("cli: the final mesh is empty")
    if not (mesh_launches["topk2_fields"] > 0 and mesh_launches["encode_fwd_moe"] > 0
            and mesh_launches["encode_fwd_moe_rays"] == 0):
        raise AssertionError(f"cli: meshing launches {mesh_launches}")
    for name in ("encode_fwd", "encode_bwd_table", "batched_gather", "encode_fwd_moe_rays"):
        if launches[name] < 1:
            raise AssertionError(f"cli: {name} never launched in the run ({launches})")
    if len(ckpts) != 1:
        raise AssertionError(f"cli: checkpoints {ckpts}")
    with np.load(ckpts[0]) as data:
        if "resume.frame_gen_state" not in data.files:
            raise AssertionError("cli: the checkpoint is not a full one")
    phase(
        "cli", frames=CONFIG["dataset_config"]["num_frames"], trained_frames=runner.engine.throughput.frames,
        eval_frames=sorted(runner.eval_frame_ids), fields=runner.engine.num_fields,
        fit_seconds=fit_s, fit_loop_wall_s=runner._loop_wall_s,
        fps_estimate=metrics["fps_estimate"], spf_estimate=metrics["spf_estimate"],
        wall_fps=metrics.get("wall_fps"),
        phases_s={k: v for k, v in metrics.items() if k.startswith("phase_")},
        online_psnr=metrics["online_psnr"], online_depthl1=metrics["online_depthl1"],
        final_psnr=metrics["final_psnr"], final_depthl1=metrics["final_depthl1"],
        mesh_vertices=len(mesh.vertices), mesh_faces=len(mesh.faces),
        extract_mesh_s=meshing["seconds"], mesh_eval_s=runner.mesh_stats["eval_s"],
        mesh_march_s=runner.mesh_stats["march_s"], mesh_blocks=runner.mesh_stats["blocks"],
        mesh_blocks_evaluated=runner.mesh_stats["blocks_evaluated"], save_model_s=meshing["save_s"],
        checkpoint_mb=ckpts[0].stat().st_size / 2**20,
        meshing_launches={k: mesh_launches[k] for k in ("topk2_fields", "encode_fwd_moe", "encode_fwd_moe_rays")},
        run_launches={k: v for k, v in launches.items() if v}, checkpoint=ckpts[0].name, card=smi,
    )
    return runner, launches, mesh_launches, ckpts[0]


def check_cli_mesh_vs_cpu(torch, meshing, runner):
    """Phase cli_mesh_vs_cpu: one whole meshing launch, on the card against
    the CPU's plain route. The CLI meshes blocks of 128 voxels a side in
    launches of ``eval_chunk`` (262,144) grid points; of those launches,
    the one with the most points near the surface is held at its own shape,
    volume max abs <= 1e-4."""
    import numpy as np

    e = runner.engine
    valid = torch.arange(e.capacity, device=e._device) < e.num_fields
    active = e._map_arrays.positions[valid].cpu().numpy()
    chunk = runner._block_size
    args = (e._map_arrays.positions, e._map_arrays.orientations, valid)
    best, best_near = None, -1
    for _, _, _, pts in meshing.mesh_blocks(active, e._field_radius, CONFIG["mesh_resolution"], 128):
        if pts is None:
            continue
        # the block's launches as meshing makes them: the last one padded with zeros
        pts = np.concatenate([pts, np.zeros(((-len(pts)) % chunk, 3), np.float32)])
        for start in range(0, len(pts), chunk):
            geo = e._fset.apply_knn_tiled(e._params, torch.from_numpy(pts[start : start + chunk]).cuda(), *args)
            near = int((geo[:, 3].abs() < 0.05).sum())
            if near > best_near:
                best, best_near = pts[start : start + chunk], near
    gpu = e._fset.apply_knn_tiled(e._params, torch.from_numpy(best).cuda(), *args)
    torch.cuda.synchronize()
    cpu_fset = copy.deepcopy(e._fset).to("cpu")
    t0 = time.perf_counter()
    cpu = cpu_fset.apply_knn_tiled(to_cpu(e._params), torch.from_numpy(best), *to_cpu(args))
    cpu_s = time.perf_counter() - t0
    err = float((gpu[:, 3].cpu() - cpu[:, 3]).abs().max())
    color_err = float((gpu[:, :3].cpu() - cpu[:, :3]).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"cli_mesh_vs_cpu: volume max abs {err} > 1e-4")
    phase("cli_mesh_vs_cpu", points=len(best), points_near_surface=best_near, max_abs_volume=err,
          max_abs_color=color_err, cpu_plain_s=cpu_s, tolerance="volume max abs <= 1e-4")


def check_cli_resume(torch, run_mapping, runner, ckpt, out_dir: pathlib.Path):
    """Phase cli_resume: a fresh runner on the card loads the full
    checkpoint; its render of a held-out frame equals the saving runner's
    (the same generator state: nothing drew since the save); then it trains
    two more frames."""
    fresh = run_mapping.NeuralGraphMapRunner(dict(runner.config, out_dir=str(out_dir)), device="cuda")
    t0 = time.perf_counter()
    fresh.load_model(ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ds = runner.dataset
    fid = sorted(runner.eval_frame_ids)[0]
    c2w = ds.get_slam_c2ws(fid, len(ds) - 1)
    want = runner.engine.render_image(c2w, ds.camera)[0]
    got = fresh.engine.render_image(c2w, ds.camera)[0]
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"cli_resume: render of frame {fid} differs by {err} > 1e-4")
    fresh.dataset = ds
    frames = [f for f in sorted(runner.train_frame_ids) if not ds.is_keyframe(f)][-2:]
    losses = [fresh.engine.process_frame(ds, f, torch.from_numpy(ds[f]["rgbd"]).cuda()) for f in frames]
    bad = [(f, k, v) for f, d in zip(frames, losses) for k, v in d.items() if not math.isfinite(v)]
    if bad or not all(losses):
        raise AssertionError(f"cli_resume: losses after the resume {bad or losses}")
    phase("cli_resume", load_model_s=load_s, render_frame=fid, max_abs_render=err, tolerance="max abs <= 1e-4",
          frame_counter=fresh.engine._frame_counter, trained_frames=frames,
          combined_losses=[d["combined"] for d in losses])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=pathlib.Path, default=None, metavar="PATH",
                        help="also profile the steady frames; write the table to PATH")
    parser.add_argument("--ab", type=int, default=0, metavar="ROUNDS",
                        help="also time the two training routes in turns, ROUNDS x (unfused, fused, fused, unfused)")
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
    from neural_graph_mapping_tpu_torch.mapping import engine, optimizer
    from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
    from neural_graph_mapping_tpu_torch.ops import cuda_build, dispatch, permuto_cuda, topk
    from neural_graph_mapping_tpu_torch.ops import losses as losses_mod
    from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

    # -- 2. build (every source, one nvcc each, in parallel) -----------------
    libs = cuda_build.load_all()
    permuto_cuda.load_library()
    topk.load_library()
    phase("build", seconds=max(lib.build_seconds for lib in libs.values()), sources=sorted(libs))
    phase("kernel_resources", kernels=kernel_resources(cuda_build, libs))

    # -- 3. kernels vs plain ------------------------------------------------
    enc_kwargs = CONFIG["model_kwargs"]["field_kwargs"]["encoding_kwargs"]
    enc = PermutohedralEncoding(**enc_kwargs)
    check_lattice(torch, permuto_cuda, enc)
    kernel_rows = check_kernels(torch, permuto_cuda, enc)
    kernel_rows.update(check_fused_kernels(torch, permuto_cuda, enc))

    # -- 4. the slice ---------------------------------------------------------
    ds = str_to_object(CONFIG["dataset_type"])(CONFIG["dataset_config"])
    ds.load_slam_results()
    frames = [torch.from_numpy(ds[i]["rgbd"]) for i in range(NUM_FRAMES)]
    ngm = engine.NeuralGraphMap(CONFIG, device="cuda")
    torch.cuda.synchronize()
    permuto_cuda.reset_launch_counts()
    topk.reset_launch_counts()
    trained, frame_s, all_losses = run_frames(torch, ngm, ds, frames)
    launches = {k: permuto_cuda.LAUNCHES[k] for k in ("encode_fwd", "encode_bwd_table", "batched_gather")}
    others = {k: v for k, v in permuto_cuda.LAUNCHES.items() if k not in launches and v}
    if others or topk.LAUNCHES["topk2_fields"]:
        raise AssertionError(f"the frame step launched other kernels: {others}, {topk.LAUNCHES}")

    iters = CONFIG["num_iterations_per_frame"]
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
    results = []
    calls = capture_calls(permuto_cuda, ("encode_fwd", "encode_bwd_table"),
                          lambda: results.append(check_iteration_against_cpu(torch, engine, ngm)))
    worst, losses = results[0]
    phase("iteration_vs_cpu", max_rel_diff=worst, tolerance="rel <= 1e-3", losses=losses)
    kernel_rows["encode_bwd_table"].update(
        check_captured_encode_bwd_table(torch, permuto_cuda, calls["encode_bwd_table"][0]))
    kernel_rows["encode_fwd"].update(check_captured_encode_fwd(torch, permuto_cuda, calls["encode_fwd"][0]))
    if args.profile is not None:
        profile_slice(torch, engine, ds, frames, statistics.mean(steady) * 1e3, args.profile)
    unfused = (statistics.median(steady) * 1e3, statistics.mean(steady) * 1e3)
    fused_launches, fused_mean_ms, captured = check_fused_slice(torch, engine, permuto_cuda, ds, frames,
                                                                unfused, smi)
    kernel_rows["encode_mlp_fwd"].update(check_captured_encode_mlp_fwd(torch, permuto_cuda,
                                                                       captured["encode_mlp_fwd"]))
    kernel_rows["encode_mlp_bwd"].update(check_captured_encode_mlp_bwd(torch, permuto_cuda,
                                                                       captured["encode_mlp_bwd"]))
    launches.update(fused_launches)
    if args.profile is not None:
        profile_slice(torch, engine, ds, frames, fused_mean_ms, args.profile.with_name(args.profile.name + ".fused"),
                      dict(CONFIG, fused_mlp=True), "profile_fused_mlp")
    if args.ab > 0:
        ab_training_routes(torch, engine, ds, frames, args.ab, smi)

    # -- 5-8. the render path on the trained map ------------------------------
    kernel_rows.update(check_render_kernels(torch, engine, permuto_cuda, topk, dispatch, ngm, ds))
    ray_launches, render_ms = check_render(torch, permuto_cuda, topk, render_metrics, ngm, ds, smi)
    carried_launches = check_render_carried(torch, permuto_cuda, topk, ngm, ds, smi)
    check_render_block_against_cpu(torch, engine, ngm, ds)
    if args.profile is not None:
        profile_render(torch, ngm, ds, render_ms, args.profile.with_name(args.profile.name + ".render"))
    launches.update(ray_launches)
    launches["encode_fwd_moe"] = carried_launches["encode_fwd_moe"]

    # -- 9-10. the gather route: 2D field sets, geometry gradients -------------
    gather_launches, gather_rows = check_field2d(torch, permuto_cuda, optimizer, NeuralFieldSet, smi)
    launches.update(gather_launches)
    kernel_rows.update(gather_rows)
    check_geometry_gradients(torch, permuto_cuda, losses_mod, ngm)

    # -- 11-13. the CLI: fit, held-out eval, meshing, checkpoint, resume -------
    from neural_graph_mapping_tpu_torch import run_mapping
    from neural_graph_mapping_tpu_torch.mapping import meshing

    with tempfile.TemporaryDirectory(prefix="ngm_cli_") as tmp:
        runner, _, mesh_launches, ckpt = check_cli(torch, permuto_cuda, topk, run_mapping,
                                                   pathlib.Path(tmp) / "runs", smi)
        check_cli_mesh_vs_cpu(torch, meshing, runner)
        check_cli_resume(torch, run_mapping, runner, ckpt, pathlib.Path(tmp) / "resumed")

    kernels = []
    for name, source, replaces in permuto_cuda.KERNELS + topk.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched on its path")
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], **kernel_rows[name]}
        if name in ("topk2_fields", "encode_fwd_moe"):
            row["meshing_launches"] = mesh_launches[name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
