"""Standalone dataset visualizer: stream a dataset's trajectories, frames,
bounds, and GT mesh to rerun (port of neural_graph_mapping_tpu.vis.vis_dataset).

Usage: python -m neural_graph_mapping_tpu_torch.vis.vis_dataset --config <dataset>.yaml
"""

from __future__ import annotations

import logging

import numpy as np

from neural_graph_mapping_tpu_torch import config as config_mod
from neural_graph_mapping_tpu_torch.utils.observability import RerunLogger

logger = logging.getLogger(__name__)


def run_dataset_visualization(config: dict, max_frames: int = 0, frame_stride: int = 5) -> None:
    dataset_type = config_mod.str_to_object(config["dataset_type"])
    dataset = dataset_type(config.get("dataset_config", {}))
    try:
        dataset.load_slam_results()
        has_slam = True
    except Exception as e:  # a scene without (readable) SLAM files still shows its frames
        logger.warning("no SLAM results to show (%s: %s)", type(e).__name__, e)
        has_slam = False

    rrl = RerunLogger("ngm_dataset_vis", rrd_path=config.get("rerun_save"))
    if not rrl.enabled:
        raise SystemExit("rerun-sdk is required for dataset visualization")
    rr = rrl._rr

    if dataset.gt_c2ws is not None:
        positions = np.asarray(dataset.gt_c2ws)[:, :3, 3]
        ok = np.isfinite(positions).all(axis=1)
        rr.log("trajectories/gt", rr.LineStrips3D([positions[ok]]), timeless=True)
    if has_slam and dataset.slam_final_c2ws is not None:
        positions = np.asarray(dataset.slam_final_c2ws)[:, :3, 3]
        ok = np.isfinite(positions).all(axis=1)
        rr.log("trajectories/slam_final", rr.LineStrips3D([positions[ok]]), timeless=True)
    if has_slam and getattr(dataset, "slam_online_c2ws", None) is not None:
        # the per-frame online estimates, beside gt and final
        positions = np.asarray(dataset.slam_online_c2ws)[:, :3, 3]
        ok = np.isfinite(positions).all(axis=1)
        rr.log("trajectories/slam_online", rr.LineStrips3D([positions[ok]]), timeless=True)

    bounds = dataset.scene_bounds
    if bounds is not None:
        rr.log(
            "bounds",
            rr.Boxes3D(centers=[bounds.mean(0)], half_sizes=[(bounds[1] - bounds[0]) / 2]),
            timeless=True,
        )
    if getattr(dataset, "has_gt_mesh", False):
        rrl.log_mesh(dataset.load_gt_mesh())

    n = len(dataset) if not max_frames else min(max_frames, len(dataset))
    for frame_id in range(0, n, frame_stride):
        item = dataset[frame_id]
        rrl.set_frame(frame_id)
        rrl.log_camera(item["c2w"], dataset.camera, item["rgbd"])


def main(argv=None) -> None:
    config = config_mod.load_config_from_args(argv)
    run_dataset_visualization(config)


if __name__ == "__main__":
    main()
