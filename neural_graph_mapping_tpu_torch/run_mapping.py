"""CLI entry point: run online neural graph mapping on a SLAM dataset (port
of neural_graph_mapping_tpu.run_mapping).

    python -m neural_graph_mapping_tpu_torch.run_mapping \\
        --config neural_graph_map.yaml synthetic.yaml [--device cpu] [--key.sub value ...]

fits the map online (frames read ahead, and uploaded on a side stream, by
:class:`FramePrefetcher`), scores held-out frames chunk by chunk and at the
end, extracts the coloured mesh and scores it against a ground-truth mesh
where the dataset has one, and writes a checkpoint (the npz keys of the JAX
package) that loads and resumes. The map runs on the card unless
``--device cpu`` is given; there is no fallback from one to the other.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import math
import os
import pathlib
import time
from collections import defaultdict
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from neural_graph_mapping_tpu_torch import config as config_mod
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.eval import render_metrics
from neural_graph_mapping_tpu_torch.mapping import meshing, optimizer
from neural_graph_mapping_tpu_torch.mapping.engine import NeuralGraphMap
from neural_graph_mapping_tpu_torch.utils import chunking, observability, profiling
from neural_graph_mapping_tpu_torch.utils.prefetch import FramePrefetcher

logger = logging.getLogger(__name__)


def mean_metric_dicts(dicts: List[dict]) -> dict:
    """Arithmetic mean of metric dicts."""
    sums = defaultdict(float)
    counts = defaultdict(int)
    for d in dicts:
        for k, v in d.items():
            sums[k] += v
            counts[k] += 1
    return {k: sums[k] / counts[k] for k in sums}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class NeuralGraphMapRunner:
    """Orchestrates fit / eval / meshing / checkpointing around the engine.

    ``device`` is where the map lives: the card by default, ``"cpu"`` only
    when asked for.
    """

    def __init__(self, config: dict, device="cuda") -> None:
        if "model_kwargs" not in config:
            raise ValueError(
                "config has no model_kwargs: name the model's config first, e.g. "
                "--config neural_graph_map.yaml synthetic.yaml"
            )
        self.config = config
        self.engine = NeuralGraphMap(config, device=device)
        self.device = self.engine._device
        self._dataset_type = config_mod.str_to_object(config["dataset_type"])
        self._dataset_config = config.get("dataset_config", {})
        self._eval_ratio = float(config.get("eval_ratio", 0.0))
        self._eval_chunk_freq = config.get("eval_chunk_freq", None)
        self._eval_render_metrics = config.get("eval_metrics", [])
        self._eval_crop = config.get("eval_crop", None)
        self._eval_mesh = bool(config.get("eval_mesh", False))
        self._eval_mesh_num_points = int(config.get("eval_mesh_num_points", 200000))
        self._eval_mesh_alignment = bool(config.get("eval_mesh_alignment", True))
        self._eval_culling_method = config.get("eval_culling_method", "virt_cams")
        self._disable_eval = bool(config.get("disable_eval", False))
        self._extract_final_mesh = bool(config.get("extract_mesh", True))
        self._mesh_resolution = float(config.get("mesh_resolution", 0.02))
        self._log_iteration_freq = int(config.get("log_iteration_freq", 100))
        self._render_vis = bool(config.get("render_vis", False))
        self._render_frames = list(config.get("render_frames", []) or [])
        self._render_frame_freq = int(config.get("render_frame_freq", 200))
        self._extract_mesh_frame_freq = int(config.get("extract_mesh_frame_freq", 100))
        self._extract_mesh_frames = set(config.get("extract_mesh_frames", []) or [])
        # per-field debug meshes after the full one
        self._extract_mesh_fields = list(config.get("extract_mesh_fields", []) or [])
        self._preview_res_factor = float(config.get("preview_res_factor", 0.3))
        # points per field-set call when meshing
        self._block_size = int(config.get("block_size", 262144))
        self._store_intermediate_meshes = bool(config.get("store_intermediate_meshes", False))
        self._eval_store_details = bool(config.get("eval_store_details", True))
        # frames read (and uploaded) ahead by the prefetch thread; 0 = synchronous
        self._prefetch_depth = int(config.get("host_prefetch_depth", 2))
        self._rerun_vis = bool(config.get("rerun_vis", False))
        self._rerun_save = config.get("rerun_save", None)
        self._rerun_connect_addr = config.get("rerun_connect_addr", None)
        self._wandb_project = config.get("wandb_project", "neural_graph_mapping_tpu")
        self._wandb_enabled = bool(config.get("wandb", False))
        profiling.benchmark.enabled = bool(config.get("benchmark", False))
        self._run_name: Optional[str] = None
        out_dir = config.get("out_dir", "runs")
        self._out_dir = pathlib.Path(out_dir) / self.run_name
        self.metrics: Dict[str, float] = {}
        self._metric_dicts_for_chunks: List[dict] = []
        self._eval_details: List[list] = []
        self._model_path = config.get("model", None)
        self._wandb = None
        self._rerun = None
        self._iteration = 0
        self.dataset = None
        self.gt_from_est = None
        # the last extract_mesh call's split: eval_s, march_s, blocks, ...
        self.mesh_stats: dict = {}

        logging.basicConfig(level=int(config.get("loglevel", 20)))

    @property
    def run_name(self) -> str:
        if self._run_name is None:
            stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            self._run_name = f"NeuralGraphMap_{stamp}"
        return self._run_name

    # -- sequence splitting ---------------------------------------------------------

    def split_sequence(self, dataset) -> None:
        all_frame_ids = list(range(len(dataset)))
        last = all_frame_ids[-1]
        self.eval_frame_ids = set()
        self.train_frame_ids = set()
        self.chunks: List[dict] = []
        if self._eval_ratio == 0.0:
            self.train_frame_ids.update(all_frame_ids)
            return
        eval_freq = math.floor(1.0 / self._eval_ratio)
        self.chunks = [{"eval_frame_ids": set(), "at_frame_id": None}]
        kf_counter = 0
        for frame_id in all_frame_ids:
            if dataset.is_keyframe(frame_id, at_frame_id=last):
                kf_counter += 1
                if self._eval_chunk_freq and kf_counter % self._eval_chunk_freq == 0:
                    self.chunks.append({"eval_frame_ids": set(), "at_frame_id": None})
                self.chunks[-1]["at_frame_id"] = frame_id
                if kf_counter % eval_freq == 0:
                    self.chunks[-1]["eval_frame_ids"].add(frame_id)
                    self.eval_frame_ids.add(frame_id)
                else:
                    self.train_frame_ids.add(frame_id)
            else:
                self.train_frame_ids.add(frame_id)

    # -- main loop -----------------------------------------------------------------

    def fit(self) -> Dict[str, float]:
        dataset = self._dataset_type(self._dataset_config)
        dataset.load_slam_results()
        self.dataset = dataset

        try:
            self.gt_from_est = dataset.gt_from_est_transform("umeyama")
        except (ValueError, AttributeError) as e:
            logger.info("trajectory alignment unavailable (%s); using identity", e)
            self.gt_from_est = None

        self.split_sequence(dataset)
        self._out_dir.mkdir(parents=True, exist_ok=True)
        (self._out_dir / "eval_data").mkdir(exist_ok=True)

        # observability: both degrade to no-ops without their packages; wandb
        # only runs where the config asks for it
        self._wandb = observability.WandbLogger(
            self._wandb_project, self.config, name=self.run_name, enabled=self._wandb_enabled
        )
        if self._rerun_vis or self._rerun_save or self._rerun_connect_addr:
            self._rerun = observability.RerunLogger(
                rrd_path=(
                    str(self._out_dir / f"{self.run_name}.rrd") if self._rerun_save else None
                ),
                connect_addr=self._rerun_connect_addr,
                spawn=self._rerun_vis and not self._rerun_save,
            )

        if self._model_path:
            self.load_model(self._model_path)

        # read (and upload) frame t+1 on a worker thread while the device
        # trains frame t
        prefetcher = None
        if self._prefetch_depth > 0:
            train_seq = [f for f in range(len(dataset)) if f in self.train_frame_ids]
            prefetcher = FramePrefetcher(
                dataset, train_seq, self._prefetch_depth, to_device=True, device=self.device
            )

        e = self.engine
        chunk_id = 0
        loop_t0 = time.perf_counter()
        try:
            for frame_id in range(len(dataset)):
                if frame_id in self.train_frame_ids:
                    t_data = time.perf_counter()
                    item = prefetcher.get(frame_id) if prefetcher else dataset[frame_id]
                    # host wait for the frame: ~0 with the prefetch thread ahead
                    e.phase_times["data_wait"] = (
                        e.phase_times.get("data_wait", 0.0) + time.perf_counter() - t_data
                    )
                    t_h2d = time.perf_counter()
                    if "rgbd_dev" in item:
                        # the prefetch thread already copied it on its stream
                        rgbd_dev = item["rgbd_dev"]
                    else:
                        rgbd_dev = torch.as_tensor(item["rgbd"], device=self.device)
                    e.phase_times["h2d"] = e.phase_times.get("h2d", 0.0) + time.perf_counter() - t_h2d
                    losses = e.process_frame(dataset, frame_id, rgbd_dev)
                    self._iteration += e._num_iterations_per_frame
                    self._log(frame_id, losses, item)
                # chunk-boundary online eval
                if chunk_id < len(self.chunks):
                    chunk = self.chunks[chunk_id]
                    if chunk["at_frame_id"] == frame_id:
                        self.evaluate_chunk(chunk)
                        chunk_id += 1
            # wall-clock mapping rate over the whole frame loop (data wait,
            # host bookkeeping and logging included)
            self._loop_wall_s = time.perf_counter() - loop_t0
        finally:
            if prefetcher is not None:
                prefetcher.close()

        if self._extract_final_mesh or self._eval_mesh:
            mesh_path = self._out_dir / "eval_data" / self._mesh_name()
            self.extract_mesh(mesh_path)
            for fid in self._extract_mesh_fields:
                self.extract_mesh(mesh_path.with_stem(f"{mesh_path.stem}_{fid}"), only_field=int(fid))

        self.evaluate_full()
        self.save_model()
        if self._wandb is not None:
            self._wandb.log(dict(self.metrics))
            self._wandb.finish()
        return self.metrics

    # -- in-loop logging ----------------------------------------------------------

    def _log(self, frame_id: int, losses: dict, item: dict) -> None:
        """Loss streaming, rerun telemetry, periodic render previews and
        intermediate meshes."""
        new_iters = self.engine._num_iterations_per_frame
        if losses and self._iteration % self._log_iteration_freq < new_iters:
            logger.info("frame %d losses %s", frame_id, {k: round(v, 4) for k, v in losses.items()})
            if self._wandb is not None and self._wandb.enabled:
                self._wandb.log({**losses, "current_frame_id": frame_id}, step=self._iteration)

        if self._rerun is not None and self._rerun.enabled:
            e = self.engine
            self._rerun.set_frame(frame_id)
            c2w = np.asarray(self.dataset.get_slam_c2ws(frame_id))
            if np.isfinite(c2w).all():
                self._rerun.log_camera(c2w, self.dataset.camera, rgbd=item["rgbd"])
            if e.num_fields > 0:
                self._rerun.log_fields(_np(e._map_arrays.positions)[: e.num_fields], e._field_radius)

        if self._render_vis and self._render_frames and (frame_id + 1) % self._render_frame_freq == 0:
            self._log_renders(frame_id)

        if (
            (self._rerun is not None and self._rerun.enabled) or self._store_intermediate_meshes
        ) and (
            (frame_id + 1) % self._extract_mesh_frame_freq == 0
            or frame_id in self._extract_mesh_frames
        ):
            mesh = self.extract_mesh(
                self._out_dir / "eval_data" / f"mesh_{frame_id:06d}.ply"
                if self._store_intermediate_meshes
                else None
            )
            if mesh is not None and self._rerun is not None and self._rerun.enabled:
                self._rerun.log_mesh(mesh)

    def _log_renders(self, frame_id: int) -> None:
        """Render-preview grid: one row per configured render frame, RGB and
        depth columns, saved as PNG under the run dir (and to wandb)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        preview_camera = self.dataset.camera.scaled_camera(self._preview_res_factor)
        n = len(self._render_frames)
        fig, ax = plt.subplots(n, 2, squeeze=False)
        for i, frac in enumerate(self._render_frames):
            fid = min(int(frac * (len(self.dataset) - 1)), frame_id)
            c2w = np.asarray(self.dataset.get_slam_c2ws(fid, frame_id))
            if not np.isfinite(c2w).all():
                continue
            rgbd = _np(self.engine.render_image(c2w, preview_camera)[0])
            ax[i, 0].imshow(np.clip(rgbd[..., :3], 0, 1))
            ax[i, 1].imshow(rgbd[..., 3], vmin=0.0, vmax=7.0)
            ax[i, 0].axis("off")
            ax[i, 1].axis("off")
            if self._rerun is not None and self._rerun.enabled:
                self._rerun.log_camera(c2w, preview_camera, rgbd=rgbd, name=f"camera_{i}")
        previews = self._out_dir / "previews"
        previews.mkdir(exist_ok=True)
        png_path = previews / f"render_{frame_id:06d}.png"
        fig.savefig(png_path, dpi=100)
        plt.close(fig)
        if self._wandb is not None and self._wandb.enabled:
            self._wandb.log_image("render_previews", str(png_path), step=self._iteration)

    def _mesh_name(self) -> str:
        prefix = "aligned_" if self.gt_from_est is not None else ""
        return f"{prefix}final.ply"

    # -- evaluation ---------------------------------------------------------------

    @profiling.benchmark
    def evaluate_frame(self, frame_id: int, at_frame_id: int) -> dict:
        """Held-out frame render metrics, plus the eval artifacts: a
        side-by-side target|render PNG and a tabulated ``details.txt``.

        ``eval_render_scale`` (< 1.0) renders at a downscaled camera and
        block-averages the target to match (depth: mean over valid pixels)."""
        c2w = self.dataset.get_slam_c2ws(frame_id, at_frame_id)
        cam = self.dataset.camera
        scale = float(self.config.get("eval_render_scale", 1.0))
        if scale != 1.0:
            cam = cam.scaled_camera(scale)
        rgbd, _ = self.engine.render_image(c2w, cam)
        target = torch.as_tensor(self.dataset[frame_id]["rgbd"], device=rgbd.device)
        if scale != 1.0:
            fh = self.dataset.camera.height // cam.height
            fw = self.dataset.camera.width // cam.width
            th, tw = cam.height * fh, cam.width * fw
            blocks = target[:th, :tw].reshape(cam.height, fh, cam.width, fw, 4)
            rgb = blocks[..., :3].mean(dim=(1, 3))
            d = blocks[..., 3]
            valid = d != 0.0
            cnt = torch.clamp(valid.sum(dim=(1, 3)), min=1)
            depth = torch.where(valid.any(dim=(1, 3)), d.sum(dim=(1, 3)) / cnt, 0.0)
            target = torch.cat([rgb, depth[..., None]], dim=-1)
        out = {}
        for metric in self._eval_render_metrics:
            if metric == "psnr":
                out["psnr"] = render_metrics.psnr(rgbd[..., :3], target[..., :3], self._eval_crop)
            elif metric == "ssim":
                out["ssim"] = render_metrics.ssim(rgbd[..., :3], target[..., :3], self._eval_crop)
            elif metric == "depthl1":
                # full-image depth L1: the protocol's depthl1 ignores the crop
                out["depthl1"] = render_metrics.depthl1(rgbd[..., 3], target[..., 3], None)
            elif metric == "lpips":
                try:
                    out["lpips"] = render_metrics.lpips(
                        rgbd[..., :3], target[..., :3], self._eval_crop
                    )
                except FileNotFoundError:
                    logger.warning("LPIPS weights unavailable; skipping lpips")

        if self._eval_store_details and out:
            img_name = f"{frame_id:06d}_{at_frame_id:06d}.png"
            comparison = np.clip(
                np.concatenate([_np(target[..., :3]), _np(rgbd[..., :3])], axis=1), 0.0, 1.0
            )
            eval_dir = self._out_dir / "eval_data"
            eval_dir.mkdir(parents=True, exist_ok=True)
            chunking.save_image(comparison, eval_dir / img_name)
            self._eval_details.append(
                [img_name] + [float(out.get(m, float("nan"))) for m in self._eval_render_metrics]
            )
            import tabulate

            with open(eval_dir / "details.txt", "w") as f:
                f.write(
                    tabulate.tabulate(
                        self._eval_details, headers=["filename", *self._eval_render_metrics]
                    )
                )
        return out

    @profiling.benchmark
    def evaluate_chunk(self, chunk: dict) -> None:
        if self._disable_eval or not chunk["eval_frame_ids"]:
            return
        dicts = [
            self.evaluate_frame(fid, chunk["at_frame_id"]) for fid in sorted(chunk["eval_frame_ids"])
        ]
        self._metric_dicts_for_chunks.append(mean_metric_dicts(dicts))

    @profiling.benchmark
    def evaluate_full(self) -> None:
        """Final metrics. ``disable_eval`` skips the render and mesh
        evaluations but still reports the throughput and parameter counts."""
        online = mean_metric_dicts(self._metric_dicts_for_chunks if not self._disable_eval else [])
        final_render = {}
        if not self._disable_eval and self._eval_render_metrics and self.eval_frame_ids:
            dicts = [
                self.evaluate_frame(fid, len(self.dataset) - 1) for fid in sorted(self.eval_frame_ids)
            ]
            final_render = mean_metric_dicts(dicts)

        final_mesh = {}
        if not self._disable_eval and self._eval_mesh and getattr(self.dataset, "has_gt_mesh", False):
            from neural_graph_mapping_tpu_torch.eval import culling
            from neural_graph_mapping_tpu_torch.utils import meshio

            est_path = self._out_dir / "eval_data" / self._mesh_name()
            if est_path.is_file():
                est_mesh = meshio.load_ply(est_path)
                final_mesh = culling.evaluate_raw_mesh(
                    est_mesh,
                    self.dataset,
                    self._eval_culling_method,
                    align=self._eval_mesh_alignment,
                    num_points=self._eval_mesh_num_points,
                )

        for k, v in online.items():
            self.metrics[f"online_{k}"] = v
        for k, v in final_render.items():
            self.metrics[f"final_{k}"] = v
        for k, v in final_mesh.items():
            self.metrics[f"mesh_{k}"] = v
        self.metrics["num_params_per_field"] = self.engine._fset.numel_per_field()
        self.metrics["num_fields"] = self.engine.num_fields
        self.metrics["num_params"] = self.metrics["num_params_per_field"] * self.metrics["num_fields"]
        self.metrics["fps_estimate"] = self.engine.fps_estimate
        self.metrics["spf_estimate"] = self.engine.spf_estimate
        for k, v in sorted(self.engine.phase_times.items()):
            self.metrics[f"phase_{k}_s"] = v
        if getattr(self, "_loop_wall_s", 0.0) > 0 and self.engine.throughput.frames:
            self.metrics["wall_fps"] = self.engine.throughput.frames / self._loop_wall_s
        logger.info("final metrics: %s", json.dumps(self.metrics, indent=2, default=float))

    # -- meshing -------------------------------------------------------------------

    @profiling.benchmark
    def extract_mesh(
        self,
        path,
        resolution: Optional[float] = None,
        min_iterations: int = 50,
        only_field: Optional[int] = None,
    ):
        e = self.engine
        ti = _np(e._map_arrays.training_iterations)
        slots = np.arange(e.capacity)
        valid = (slots < e.num_fields) & (ti >= min_iterations)
        if only_field is not None:
            # single-field debug mesh: the field is selected first, so the
            # min_iterations fallback applies to it, not to the rest
            valid = (slots < e.num_fields) & (slots == only_field)
            if not valid.any():
                logger.warning(
                    "extract_mesh(only_field=%s): no such allocated field (num_fields=%d); skipping",
                    only_field, e.num_fields,
                )
                return None
        elif not valid.any():
            valid = slots < e.num_fields
        return meshing.extract_mesh(
            e._fset,
            e._params,
            e._map_arrays.positions,
            e._map_arrays.orientations,
            torch.from_numpy(valid).to(self.device),
            e._field_radius,
            e._rcfg.geometry_mode,
            e._rcfg.geometry_factor,
            color_factor=e._rcfg.color_factor,
            resolution=resolution or self._mesh_resolution,
            transform=self.gt_from_est,
            eval_chunk=self._block_size,
            mesh_file_path=path,
            stats=self.mesh_stats,
        )

    # -- checkpointing -------------------------------------------------------------

    def save_model(self, path: Optional[os.PathLike] = None, full: Optional[bool] = None) -> pathlib.Path:
        """Checkpoint the map under the JAX package's npz keys. ``full=True``
        also saves the online bookkeeping (pose graph, kf->fields index,
        keyframe cache, slot tables, Adam state) so ``load_model`` can resume
        mapping, and the port's own keys: the frame counter and the states
        of both generators, so a resumed run draws what an uninterrupted one
        would. Defaults to the ``checkpoint_full`` config key."""
        path = pathlib.Path(path) if path else self._out_dir / f"{self.run_name}.npz"
        if full is None:
            full = bool(self.config.get("checkpoint_full", False))
        e = self.engine
        m = e._map_arrays
        arrays = {f"params.{k}": _np(v) for k, v in e._params.items()}
        arrays.update(
            {
                "map.positions": _np(m.positions),
                "map.orientations": _np(m.orientations),
                "map.kf_ids": _np(m.kf_ids),
                "map.kf_slots": _np(m.kf_slots),
                "map.training_iterations": _np(m.training_iterations),
                "num_fields": np.asarray(e.num_fields),
            }
        )
        if full:
            state = {
                "graph": {int(k): sorted(v) for k, v in e._graph.items()},
                "kf2fields": {int(k): sorted(int(i) for i in v) for k, v in e._kf2fields.items()},
                "kf_ids": sorted(e._kf_ids),
                "last_update": e._last_update,
                "frame_to_slot": {int(k): int(v) for k, v in e._frame_to_slot.items()},
                "free_slots": list(e._free_slots),
                "frames_processed": e.throughput.frames,
                "total_optimization_time": e.throughput.total_seconds,
            }
            arrays["resume.state_json"] = np.frombuffer(json.dumps(state).encode(), dtype=np.uint8)
            if e._prev_kf2w_slots is not None:
                arrays["resume.prev_kf2w_slots"] = e._prev_kf2w_slots
            arrays["resume.cache_c2w"] = e._cache_c2w_np
            arrays["resume.cache_valid"] = e._cache_valid_np
            arrays["resume.bb_min"] = e._bb_min
            arrays["resume.bb_max"] = e._bb_max
            if e._cache_rgb is not None:
                # bf16 -> fp16 is exact for 8-bit imagery in [0, 1]
                arrays["resume.cache_rgb"] = _np(e._cache_rgb.to(torch.float16))
                arrays["resume.cache_depth"] = _np(e._cache_depth)
            for k, v in e._adam.m.items():
                arrays[f"resume.adam_m.{k}"] = _np(v)
            for k, v in e._adam.v.items():
                arrays[f"resume.adam_v.{k}"] = _np(v)
            arrays["resume.adam_steps"] = _np(e._adam.steps)
            # the JAX package saves its threefry keys here instead
            arrays["resume.frame_counter"] = np.asarray(e._frame_counter)
            arrays["resume.init_gen_state"] = _np(e._init_gen.get_state())
            arrays["resume.frame_gen_state"] = _np(e._frame_gen.get_state())
        np.savez_compressed(path, **arrays)

        model_config = copy.deepcopy(self.config)
        model_config["model"] = str(path)
        if self.metrics:
            model_config["results"] = self.metrics
        config_mod.save_config_to_file(path.with_suffix(".yaml"), model_config)
        config_mod.save_config_to_file(path.parent / "latest_run.yaml", model_config)
        logger.info("saved model to %s", path)
        return path

    def load_model(self, path: os.PathLike) -> None:
        """Load a checkpoint of either package. A full checkpoint restores
        the mapping state; a JAX one restores all of it but the generators,
        which keep this runner's seed."""
        logger.info("loading model from %s", path)
        e = self.engine
        dev = self.device
        with np.load(path) as npz:
            data = {k: npz[k] for k in npz.files}
        params = {k[len("params."):]: v for k, v in data.items() if k.startswith("params.")}
        if "enc.table" in params:
            # layout guard: tables are (N, F, L, T), feature-axis major. A
            # level-major (N, L, F, T) table has the same element count, so
            # every consumer's reshape would silently interleave levels into
            # features; fail loudly instead.
            enc = e._fset.prototype.encoding
            t = params["enc.table"]
            want = (enc.nr_feat_per_level, enc.nr_levels)
            if t.ndim == 4 and t.shape[1:3] != want:
                raise ValueError(
                    f"checkpoint enc.table has shape {t.shape}; expected "
                    f"(N, F={want[0]}, L={want[1]}, T) — this looks like a "
                    "pre-layout-flip checkpoint (level-major tables); "
                    "re-save it or transpose axes 1 and 2"
                )
        e._params = interop.params_from_jax(params, dev)
        e._map_arrays = interop.map_arrays_from_jax(
            data["map.positions"], data["map.orientations"], data["map.kf_ids"],
            data["map.kf_slots"], data["map.training_iterations"], dev,
        )
        e._num_fields = int(data["num_fields"])
        e._adam = optimizer.init_adam_state(e._params)

        if "resume.state_json" not in data:
            return
        state = json.loads(bytes(data["resume.state_json"]).decode())
        e._graph = {int(k): set(v) for k, v in state["graph"].items()}
        e._kf2fields = {int(k): set(v) for k, v in state["kf2fields"].items()}
        e._kf_ids = set(state["kf_ids"])
        e._last_update = state["last_update"]
        e._frame_to_slot = {int(k): int(v) for k, v in state["frame_to_slot"].items()}
        e._free_slots = list(state["free_slots"])
        e.throughput.frames = int(state["frames_processed"])
        e.throughput.total_seconds = float(state["total_optimization_time"])
        if "resume.prev_kf2w_slots" in data:
            e._prev_kf2w_slots = data["resume.prev_kf2w_slots"]
        e._cache_c2w_np = data["resume.cache_c2w"]
        e._cache_valid_np = data["resume.cache_valid"]
        e._cache_c2w_dirty = True  # re-upload the device mirrors
        e._cache_valid_dirty = True
        e._bb_min = data["resume.bb_min"]
        e._bb_max = data["resume.bb_max"]
        if "resume.cache_rgb" in data:
            e._cache_rgb = torch.from_numpy(data["resume.cache_rgb"]).to(dev).to(torch.bfloat16)
            e._cache_depth = torch.from_numpy(data["resume.cache_depth"]).to(dev)
        if "resume.adam_steps" in data:
            e._adam = interop.adam_from_jax(
                {k[len("resume.adam_m."):]: v for k, v in data.items() if k.startswith("resume.adam_m.")},
                {k[len("resume.adam_v."):]: v for k, v in data.items() if k.startswith("resume.adam_v.")},
                data["resume.adam_steps"],
                dev,
            )
        if "resume.frame_counter" in data:
            e._frame_counter = int(data["resume.frame_counter"])
            e._init_gen.set_state(torch.from_numpy(data["resume.init_gen_state"]))
            e._frame_gen.set_state(torch.from_numpy(data["resume.frame_gen_state"]))
        else:
            logger.info(
                "checkpoint holds no generator states (a JAX checkpoint saves threefry keys); "
                "draws continue from this runner's seed"
            )


def main(argv=None) -> None:
    """Entry point. The JAX package enables its persistent XLA compilation
    cache here; the port compiles nothing per shape (its kernels are built
    once into ``_build/``), so it has no counterpart."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    config = config_mod.load_config_from_args(rest, default_config=["neural_graph_map.yaml"])
    runner = NeuralGraphMapRunner(config, device=known.device)
    metrics = runner.fit()
    print(json.dumps(metrics, default=float))


if __name__ == "__main__":
    main()
