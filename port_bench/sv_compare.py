"""The program's single-view sampler against the plain reference
(:mod:`port_bench.reference.single_view`) on the state the timed path runs
from, run by hand on the card:

    python3 -m port_bench.sv_compare --workload sv_replay --seeds S [S ...] [--frames 2]

For each seed the cell's set-up runs as the benchmark runs it: the map from
the seed's draws, the warm-up frames read from the written lap through the
program's reader and prefetcher. The window's first ``--frames`` frames then
train through ``process_frame``, and each single-view iteration's sampler
call is held against the reference on the same cache, map and draws: the
reference chooses the view itself, then draws its targets. Field ids,
validity, pixels and the pixels' RGB-D must be equal; near, far and
ground-truth distances agree within ``DISTANCE_TOL`` metres, since the
reference computes a ray's direction and the depth's distance along it in
another order of float32 operations (a few ulps of distances under 10 m).
On the card three more frames probe host syncs (:func:`sync_probe`): the
single-view device program outside the core it shares with the multi-view
step must have none.

One JSON line an iteration, one a seed; exit 1 where anything parts.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import sys
import time
import traceback
import warnings

import torch

from port_bench import manifest as mf
from port_bench import run
from port_bench import scene as scene_mod
from port_bench.reference import single_view as ref

DISTANCE_TOL = 1e-5  # metres


def _bound(fn, args, kwargs) -> dict:
    b = inspect.signature(fn).bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


def _gap(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor) -> float:
    if not bool(keep.any()):
        return 0.0
    return float((a[keep].double() - b[keep].double()).abs().max())


def held_against_reference(it: dict, call: dict, target) -> dict:
    """One sampler call of the program (``call``, its target ``target``, in
    the iteration ``it``) against the reference's draw on the same inputs."""
    draws = it["draws"]
    slot = ref.choose_view(it["cache_valid"], draws.slot_gumbel, it["iter_idx"])
    view, view_c2w = ref.view_of(it["cache_rgb"], it["cache_depth"], it["cache_c2w"], slot)
    fx, fy, cx, cy, _ = call["camera"].get_pinhole_camera_parameters(0.0)
    want = ref.draw_targets(view, view_c2w, it["map_positions"], it["active_mask"], float(call["field_radius"]),
                            call["num_train_fields"], call["num_rays_per_field"], ref.Pinhole(fx, fy, cx, cy),
                            call["cloud_idx"], call["u_fields"], call["u_rays"])
    valid = want.field_valid
    rows = valid[:, None].expand_as(want.near)
    same_valid = torch.equal(target.field_valid, valid)
    clear = (want.gt_distances - want.far).abs() > DISTANCE_TOL  # masks compared off the far end's rounding
    return {
        "iteration": int(it["iter_idx"]), "slot": slot,
        "view_equal": torch.equal(call["rgbd_image"], view) and torch.equal(call["c2w"], view_c2w),
        "valid_equal": same_valid,
        "ids_equal": same_valid and torch.equal(target.field_ids[valid], want.field_ids[valid]),
        "pixels_equal": torch.equal(target.ijs, want.ijs), "rgbd_equal": torch.equal(target.rgbds, want.rgbds),
        "near_gap": _gap(target.near_distances, want.near, rows), "far_gap": _gap(target.far_distances, want.far, rows),
        "gt_gap": _gap(target.gt_distances, want.gt_distances, rows),
        "mask_parts": int(((target.depth_mask != want.depth_mask) & clear).sum()),
        "slots_valid": int(valid.sum()), "eligible": int(want.eligible.sum()), "boundary_pairs": want.boundary_pairs,
    }


def passed(rec: dict) -> bool:
    return (rec["view_equal"] and rec["valid_equal"] and rec["ids_equal"] and rec["pixels_equal"]
            and rec["rgbd_equal"] and rec["mask_parts"] == 0
            and max(rec["near_gap"], rec["far_gap"], rec["gt_gap"]) <= DISTANCE_TOL)


@contextlib.contextmanager
def hooked(engine, sampling, out: list):
    """Hold every single-view sampler call against the reference into ``out``."""
    real_iter, real_sample = engine.optimization_iteration_sv, sampling.sample_target_sv
    current = {}

    def iteration(*args, **kwargs):
        current.update(_bound(real_iter, args, kwargs))
        return real_iter(*args, **kwargs)

    def sample(*args, **kwargs):
        target = real_sample(*args, **kwargs)
        out.append(held_against_reference(current, _bound(real_sample, args, kwargs), target))
        return target

    engine.optimization_iteration_sv, sampling.sample_target_sv = iteration, sample
    try:
        yield
    finally:
        engine.optimization_iteration_sv, sampling.sample_target_sv = real_iter, real_sample


def _where(exc: BaseException) -> str:
    """The innermost line of the program in ``exc``'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if "neural_graph_mapping_tpu_torch" in f.filename]
    return f"{frames[-1].filename.rsplit('/', 2)[-1]}:{frames[-1].lineno}" if frames else "?"


@contextlib.contextmanager
def strict_outside_core(engine):
    """Sync debug mode "error" over the block, except inside
    ``_optimization_iteration_core`` (gather, render, losses, backward,
    Adam), which the single-view iteration shares with the multi-view one."""
    core = engine._optimization_iteration_core

    def lenient(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    engine._optimization_iteration_core = lenient
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        engine._optimization_iteration_core = core


def sync_probe(ngm, engine, step) -> dict:
    """Three frames: the device program (``_frame_step``) under sync debug
    mode "error" outside the shared core; a whole frame under "warn" (each
    line that synced); the shared core under "error" with anomaly mode, which
    names the backward operation where one syncs. -> what each found."""
    out = {}
    real = ngm._frame_step

    def strict(*args, **kwargs):
        with strict_outside_core(engine):
            return real(*args, **kwargs)

    ngm._frame_step = strict
    try:
        step()
        out["frame_step_outside_core"] = "none"
    except RuntimeError as exc:
        out["frame_step_outside_core"] = f"raised at {_where(exc)}: {exc}"
    finally:
        ngm._frame_step = real
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["frame_syncs"] = sorted({f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in caught
                                 if "synchroniz" in str(w.message)})
    core = engine._optimization_iteration_core

    def strict_core(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.autograd.detect_anomaly(check_nan=False):
                return core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._optimization_iteration_core = strict_core
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            step()
            out["core"] = "none"
        except RuntimeError as exc:
            named = [str(w.message).splitlines()[0] for w in caught if "Error detected in" in str(w.message)]
            out["core"] = f"raised at {_where(exc)}: {exc}; {'; '.join(named)}"
        finally:
            engine._optimization_iteration_core = core
    return out


def compare_run(cfg: dict, wl: dict, seed: int, frames: int, device) -> dict:
    """The cell's set-up, then its window's first ``frames`` frames held
    against the reference -> {"iterations": [...], "map": ..., "syncs": ...}."""
    _, engine, _, _ = run.program_modules()
    from neural_graph_mapping_tpu_torch.mapping import sampling

    sc = cfg["scene"]
    phase = run.phase_of(seed, int(sc["lap_frames"]))
    _, poses = scene_mod.cast_lap(sc, device, [])
    ngm, ds = run.build_map(cfg, seed, phase, poses, device)
    prefetch = run.replay_input(cfg, wl, phase, device)
    n_warm = int(wl["warmup_frames"])
    records: list = []
    out = {}
    try:
        def step(f: int) -> None:
            ngm.process_frame(ds, f, prefetch.get(f)["rgbd_dev"])

        for f in range(n_warm):
            step(f)
        out["map"] = run.map_state_line(ngm)
        for f in range(n_warm, n_warm + frames):
            with hooked(engine, sampling, records):
                step(f)
            for rec in records:
                rec.setdefault("frame", f)
        if torch.device(device).type == "cuda":
            later = iter(range(n_warm + frames, 10**7))
            out["syncs"] = sync_probe(ngm, engine, lambda: step(next(later)))
    finally:
        prefetch.close()
    out["iterations"] = records
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sv_replay")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.sv_compare: needs a CUDA device", file=sys.stderr)
        return 2
    from neural_graph_mapping_tpu_torch.ops import cuda_build

    cuda_build.load_all()
    wl = mf.load_workload(args.workload)
    cfg = mf.load_config(wl["config"])
    ok = True
    for seed in args.seeds:
        t = time.perf_counter()
        res = compare_run(cfg, wl, seed, args.frames, "cuda")
        for rec in res["iterations"]:
            print(json.dumps({"seed": seed, **rec, "passed": passed(rec)}), flush=True)
        good = bool(res["iterations"]) and all(passed(r) for r in res["iterations"])
        ok &= good and res.get("syncs", {}).get("frame_step_outside_core") == "none"
        print(json.dumps({"seed": seed, "iterations": len(res["iterations"]), "all_passed": good,
                          "map_at_window_start": res["map"], "syncs": res.get("syncs"),
                          "seconds": time.perf_counter() - t, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
