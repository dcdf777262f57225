"""Run one cell of the benchmark of neural_graph_mapping_tpu_torch.

    python3 -m port_bench --workload NAME --seed N --seconds S --trace 0|1

Set-up builds the cell's map on the card, drives it from the seed through
its first frames, and hands that same map to a window of ``--seconds``.
Every cell is a closed loop: the next frame or image starts when the last
one ends. With ``--trace 0`` the result line holds the cell's end-to-end
metrics; with ``--trace 1`` a shorter window runs under ``torch.profiler``
and the line holds its per-layer metrics, the device's busy seconds and a
breakdown. The last line of standard output is the result (one JSON
object); the numbers compared with the reference, each beside its limit,
end standard error and the result's ``checks``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import pathlib
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from port_bench import manifest as mf
from port_bench import scene as scene_mod
from port_bench import tracing, traffic
from port_bench.reference import check

CACHE = mf.HERE / ".cache"
PHASES = ("graph", "alloc", "host_misc")


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"nvidia_smi": f"not available: {exc}"}
    return {"nvidia_smi": out.stdout.strip() or out.stderr.strip()}


def log_setup(t_start: float, marks: dict) -> None:
    """Where set-up went: seconds to the loop's start (the interpreter, the
    imports, CUDA and the kernels' load) and of each stage after it."""
    names = list(marks)
    log(phase="setup", to_loop_s=marks["start"] - t_start,
        **{f"{b}_s": marks[b] - marks[a] for a, b in zip(names, names[1:])})


def map_state_line(ngm) -> dict:
    return {"fields": ngm.num_fields, "capacity": ngm.capacity, "keyframes": len(ngm._kf_ids)}


def phase_seconds(ngm) -> Dict[str, float]:
    return {k: float(ngm.phase_times.get(k, 0.0)) for k in PHASES}


def program_modules():
    """The program's modules that the cells drive."""
    from neural_graph_mapping_tpu_torch import camera
    from neural_graph_mapping_tpu_torch.mapping import engine
    from neural_graph_mapping_tpu_torch.ops import dispatch, permuto_cuda

    return camera, engine, dispatch, permuto_cuda


def phase_of(seed: int, lap_frames: int) -> int:
    """The orbit's starting pose for ``seed``."""
    return traffic.stream_seed(seed, "phase") % lap_frames


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def traced_window(traced: bool, permuto_cuda, dispatch, map_config: dict):
    """-> (profiler, entry counter) over the traced window, or (None, None)."""
    if not traced:
        yield None, None
        return
    fk = map_config["model_kwargs"]["field_kwargs"]
    features = fk["encoding_kwargs"]["nr_levels"] * fk["encoding_kwargs"]["nr_feat_per_level"]
    hidden = fk.get("dim_mlp_out") or features
    widths = [features] + [hidden] * int(fk["num_layers"]) + [int(fk["dim_out"])]
    with tracing.profiled() as prof, tracing.EntryCounter(permuto_cuda, dispatch, widths) as counter:
        yield prof, counter


def build_map(cfg: dict, seed: int, phase: int, poses, device):
    """The program's map of the cell and the dataset it reads poses from."""
    camera_mod, engine, _, _ = program_modules()
    sc, mc = cfg["scene"], cfg["map"]
    cam = camera_mod.Camera.create(width=sc["width"], height=sc["height"], fx=sc["fx"], fy=sc["fy"],
                                   cx=sc["width"] / 2.0, cy=sc["height"] / 2.0)
    ds = traffic.lap_dataset(cam, poses, phase, sc)
    return engine.NeuralGraphMap(mc, device, draws=traffic.SeededDraws(seed, mc, device)), ds


def write_replay_lap(cfg: dict, name: str, device) -> pathlib.Path:
    """The lap of configuration ``name`` in the NRGBD layout, PNGs written as
    datasets write them (:mod:`port_bench.pngwrite`), once per checkout:
    it does not depend on the seed. -> the dataset's root directory."""
    from concurrent.futures import ThreadPoolExecutor

    from port_bench import pngwrite

    sc = cfg["scene"]
    tag = hashlib.sha256(json.dumps(sc, sort_keys=True).encode()).hexdigest()[:12]
    root = CACHE / "replay" / f"{name}-{tag}"
    if (root / "complete").is_file():
        return root
    frames, poses = scene_mod.cast_lap(sc, device)
    scene_dir = root / "synthetic"
    for sub in ("images", "depth"):
        (scene_dir / sub).mkdir(parents=True, exist_ok=True)

    def write(i: int) -> int:
        f = frames[i]
        rgb = np.round(f[..., :3] * 255.0).astype(np.uint8)
        depth = np.round(f[..., 3] * 1000.0).astype(np.uint16)
        return (pngwrite.write_png(scene_dir / "images" / f"img{i:04d}.png", rgb)
                + pngwrite.write_png(scene_dir / "depth" / f"depth{i:04d}.png", depth))

    with ThreadPoolExecutor(8) as pool:
        written = sum(pool.map(write, range(len(poses))))
    np.savetxt(scene_dir / "poses.txt", poses.reshape(-1, 4))
    (root / "complete").write_text(json.dumps({"frames": len(poses), "bytes": written}))
    return root


class LapReader:
    """Frame ``f`` of the stream, read through the program's NRGBD loader
    from the written lap (lap frame ``(phase + f) % N``)."""

    def __init__(self, dataset, phase: int) -> None:
        self._ds, self._phase = dataset, int(phase)

    def __getitem__(self, frame_id: int) -> dict:
        return self._ds[(self._phase + int(frame_id)) % len(self._ds)]


def replay_input(cfg: dict, wl: dict, phase: int, device):
    """The replay cell's frame source: the program's ``NRGBDDataset`` over
    the written lap behind its ``FramePrefetcher(to_device=True)``, as
    ``run_mapping`` reads a dataset."""
    from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
    from neural_graph_mapping_tpu_torch.utils.prefetch import FramePrefetcher

    sc = cfg["scene"]
    root = write_replay_lap(cfg, wl["config"], device)
    ds = NRGBDDataset({
        "root_dir": str(root), "scene": "synthetic", "images_dir": "images", "depth_dir": "depth",
        "poses_file": "poses.txt", "pose_source": "gt", "pg_source": "fixed_kf_freq",
        "fixed_kf_freq": sc["keyframe_every"],
        "camera": {"width": sc["width"], "height": sc["height"], "fx": sc["fx"], "fy": sc["fy"],
                   "cx": sc["width"] / 2.0, "cy": sc["height"] / 2.0, "pixel_center": 0.0},
    })
    return FramePrefetcher(LapReader(ds, phase), range(10**7), depth=int(cfg["map"].get("host_prefetch_depth", 2)),
                           to_device=True, device=device)


def train_frame(ngm, ds, f: int, rgbd, program: dict) -> None:
    """Frame ``f`` through ``process_frame``, keeping what the reference
    compares: the frame's losses and, after frame 0, Adam's first moment."""
    program["losses"].append(ngm.process_frame(ds, f, rgbd))
    if f == 0:
        program["first_m"] = {k: v.detach().to("cpu", copy=True) for k, v in ngm._adam.m.items()}


def run_stream(cfg: dict, wl: dict, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """A stream cell: frames of the lap through ``process_frame``. Input
    ``memory``: decoded float32 RGB-D from host memory, as a camera SDK
    hands them; ``replay``: read from disk (:func:`replay_input`)."""
    _, _, dispatch, permuto_cuda = program_modules()
    sc, mc = cfg["scene"], cfg["map"]
    lap = int(sc["lap_frames"])
    phase = phase_of(seed, lap)
    replay = wl.get("input", "memory") == "replay"
    marks = {"start": time.perf_counter()}
    prefetch = replay_input(cfg, wl, phase, device) if replay else None
    n_warm = int(wl["warmup_frames"])  # the reference follows every one
    frames, poses = scene_mod.cast_lap(sc, device, [(phase + f) % lap for f in range(n_warm)] if replay else None)
    marks["frames"] = time.perf_counter()
    ngm, ds = build_map(cfg, seed, phase, poses, device)
    waits = []

    def frame(f: int):
        if prefetch is None:
            return frames[ds.pose_index(f)]
        t = time.perf_counter()
        with tracing.span("prefetch_get"):
            item = prefetch.get(f)
        waits.append(time.perf_counter() - t)
        return item["rgbd_dev"]

    program = {"losses": []}
    try:
        for f in range(n_warm):
            train_frame(ngm, ds, f, frame(f), program)
        program.update(check.map_of(ngm, "cpu"))
        sync(device)
        marks["warmup"] = time.perf_counter()
        log_setup(t_start, marks)
        at_start = map_state_line(ngm)
        phases0 = phase_seconds(ngm)
        f = n_warm
        times = []
        waits.clear()
        window = min(seconds, float(wl["trace_seconds"])) if traced else seconds
        with traced_window(traced, permuto_cuda, dispatch, mc) as (prof, counter):
            setup_s = time.perf_counter() - t_start
            with tracing.span("window"):
                t0 = last = time.perf_counter()
                while last - t0 < window:
                    rgbd = frame(f)
                    with tracing.span("process_frame"):
                        ngm.process_frame(ds, f, rgbd)
                    now = time.perf_counter()
                    times.append(now - last)
                    last, f = now, f + 1
    finally:
        if prefetch is not None:
            prefetch.close()
    window_s = last - t0
    phases1 = phase_seconds(ngm)
    rec = {"setup_s": setup_s, "window_s": window_s, "frame_s": times, "prof": prof, "counter": counter,
           "phase_s": {k: phases1[k] - phases0[k] for k in PHASES}, "at_start": at_start,
           "at_end": map_state_line(ngm), "input_wait_s": sum(waits) if replay else None,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0}
    del ngm
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reference = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n_warm)
    log(phase="check", frames=n_warm, reference_s=time.perf_counter() - t)
    rec.update(checks=check.training_gaps(program, reference), program=program, reference=reference,
               inputs=(frames, poses, phase))
    return rec


def run_render(cfg: dict, wl: dict, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """A render cell: set-up trains the map on the lap's first frames, then
    the window renders full images at the poses of the non-keyframes of
    that arc, in turn; an image completes when its RGB-D is on the host."""
    _, _, dispatch, permuto_cuda = program_modules()
    sc, mc = cfg["scene"], cfg["map"]
    n_train = int(wl["train_frames"])
    phase = phase_of(seed, int(sc["lap_frames"]))
    marks = {"start": time.perf_counter()}
    frames, poses = scene_mod.cast_lap(sc, device, [(phase + f) % int(sc["lap_frames"]) for f in range(n_train)])
    marks["frames"] = time.perf_counter()
    ngm, ds = build_map(cfg, seed, phase, poses, device)
    program = {"losses": []}
    for f in range(n_train):
        train_frame(ngm, ds, f, frames[ds.pose_index(f)], program)
    views = [ds.get_slam_c2ws(f) for f in range(n_train) if not ds.is_keyframe(f)]
    marks["train"] = time.perf_counter()
    ngm.render_image(views[0], ds.camera)[0].cpu()  # warm-up: the one shape the window renders
    sync(device)
    marks["warmup"] = time.perf_counter()
    log_setup(t_start, marks)
    at_start = map_state_line(ngm)
    images, states, times = [], [], []
    counter = None
    window = min(seconds, float(wl["trace_seconds"])) if traced else seconds
    with traced_window(traced, permuto_cuda, dispatch, mc) as (prof, counter):
        setup_s = time.perf_counter() - t_start
        with tracing.span("window"):
            t0 = last = time.perf_counter()
            while last - t0 < window:
                c2w = views[len(images) % len(views)]
                states.append(ngm._init_gen.get_state())
                with tracing.span("render_image"):
                    images.append(ngm.render_image(c2w, ds.camera)[0].cpu())
                now = time.perf_counter()
                times.append(now - last)
                last = now
    window_s = last - t0
    rec = {"setup_s": setup_s, "window_s": window_s, "image_s": times, "prof": prof, "counter": counter,
           "at_start": at_start, "at_end": map_state_line(ngm),
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0}
    block = ngm.render_block_size()
    program.update(check.map_of(ngm, "cpu"))
    del ngm
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(traffic.stream_seed(seed, "check"))
    full_blocks = (sc["width"] * sc["height"]) // block
    samples = []
    for i in rng.choice(len(images), size=min(int(wl["check_images"]), len(images)), replace=False):
        flat = images[i].reshape(-1, 4)
        for b in rng.choice(full_blocks, size=int(wl["check_blocks"]), replace=False):
            samples.append((views[i % len(views)], states[i], int(b), flat[b * block:(b + 1) * block]))
    t = time.perf_counter()
    reference = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n_train)
    reference["own"] = check.render_blocks(mc, sc, reference, samples, device)
    reference["followed"] = check.render_blocks(mc, sc, program, samples, device)
    log(phase="check", frames=n_train, blocks=len(samples), reference_s=time.perf_counter() - t)
    rec.update(checks=render_numbers(program, reference, [s[3] for s in samples]), program=program,
               reference=reference, inputs=(frames, poses, phase, samples))
    return rec


def render_numbers(program: dict, reference: dict, blocks: list) -> Dict[str, float]:
    """The numbers a render cell can compare: the set-up's training
    (:func:`check.training_gaps`), ``render_gap`` (the window's blocks
    against the reference's render of the program's map) and ``image_gap_*``
    (against the reference's render of its own map)."""
    numbers = check.training_gaps(program, reference)
    numbers["render_gap"] = check.widest_gap(blocks, reference["followed"])
    numbers.update(check.image_gaps(blocks, reference["own"]))
    return numbers


LOOPS = {"stream": run_stream, "render": run_render}


def end_to_end(rec: dict) -> Dict[str, float]:
    """Every end-to-end metric a loop's record gives."""
    out = {"setup_s": rec["setup_s"]}
    if "frame_s" in rec:
        out["frame_ms"] = 1e3 * rec["window_s"] / len(rec["frame_s"])
        out["frame_ms_p95"] = 1e3 * float(np.percentile(rec["frame_s"], 95))
    if "image_s" in rec:
        out["render_ms"] = 1e3 * rec["window_s"] / len(rec["image_s"])
    return out


def per_layer(rec: dict, wl_name: str, trace_path: pathlib.Path) -> tuple:
    """-> (the reading that readers take, the trace's reduction)."""
    rec["prof"].export_chrome_trace(str(trace_path))
    counter = rec["counter"]
    red = tracing.reduce_trace(trace_path, counter.calls)
    entries = counter.totals()
    if red["per_call_s"] is not None:
        i = 0
        per_call = red["per_call_s"]
        for name, _ in counter.calls:
            entries[name].setdefault("device_s", 0.0)
            entries[name]["device_s"] += per_call[i]
            i += 1
    for e in entries.values():
        e["bound_s"] = sum(e["bound_s"])
    done = len(rec.get("frame_s", rec.get("image_s", [])))
    reading = {"workload": wl_name, "frames": len(rec.get("frame_s", [])), "images": len(rec.get("image_s", [])),
               "done": done, "window_s": rec["window_s"], "trace": red, "entries": entries,
               "phase_s": rec.get("phase_s"), "input_wait_s": rec.get("input_wait_s")}
    return reading, red


def run_cell(name: str, cfg: dict, wl: dict, mfst: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run of the cell ``name`` -> the result object (the harness's look
    for a card is the caller's)."""
    rec = LOOPS[wl["loop"]](cfg, wl, seed, seconds, trace, device, t_start)
    numbers = rec["checks"]
    log(phase="numbers", **numbers)
    limits = {k: float(v) for k, v in wl["check"].items()}
    correct = check.verdict(numbers, limits)
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": len(rec.get("frame_s", rec.get("image_s", []))),
              "failed": 0}
    done = rec.get("frame_s", rec.get("image_s", []))
    quarters = [1e3 * float(np.mean(q)) for q in np.array_split(np.asarray(done), 4) if len(q)]
    log(phase="window", window_start=rec["at_start"], window_end=rec["at_end"], quarters_ms=quarters,
        memory_peak_bytes=int(rec["memory_peak_bytes"]), **card_line())
    if trace:
        CACHE.mkdir(parents=True, exist_ok=True)
        reading, red = per_layer(rec, name, CACHE / f"trace-{name}.json")
        values = {}
        for m in mf.cell_metrics(mfst, name, "per_layer"):
            v = mf.load_reader(m["name"]).read(reading)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = values
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        log(phase="trace", path=str(CACHE / f"trace-{name}.json"), launches=red["launches"],
            entries={k: {kk: vv for kk, vv in v.items()} for k, v in reading["entries"].items()})
    else:
        e2e = end_to_end(rec)
        units = {m["name"]: m["unit"] for m in mfst["end_to_end"]}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": units[m["name"]]}
                             for m in mf.cell_metrics(mfst, name, "end_to_end")}
    result["device"] = device_info
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    mfst = mf.load_manifest()
    entry = mf.cell_entry(mfst, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"port_bench: the cell needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from neural_graph_mapping_tpu_torch.ops import cuda_build

    cuda_build.load_all()  # built under the package's _build/ on a checkout's first run
    wl = mf.load_workload(args.workload)
    cfg = mf.load_config(wl["config"])
    result = run_cell(args.workload, cfg, wl, mfst, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    foreign = mf.foreign_modules(sys.modules)
    if foreign:
        print(f"port_bench: JAX or the JAX package was loaded: {foreign}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
