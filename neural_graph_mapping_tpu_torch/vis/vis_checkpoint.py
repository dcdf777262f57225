"""Checkpoint inspector and editor: load a saved model, render views, stream
fields and renders to rerun, and write field-pose edits back (port of
neural_graph_mapping_tpu.vis.vis_checkpoint).

Pose edits come from the config / CLI (``edits``) or the
:func:`edit_fields` API; the map is re-rendered to inspect the effect, and
``save`` writes the edited checkpoint. The 3D view streams to rerun where
it is installed. The map lives on the card unless ``--device cpu`` is given.

Usage:
  python -m neural_graph_mapping_tpu_torch.vis.vis_checkpoint --config run.yaml \\
      [--device cpu] [--frames "[0, 50]"] \\
      [--edits "[{'field_id': 3, 'position': [1.0, 0.5, 0.0]}, \\
                 {'field_ids': [0, 1], 'translate': [0.1, 0, 0]}]"] \\
      [--save edited.npz]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_graph_mapping_tpu_torch import config as config_mod
from neural_graph_mapping_tpu_torch.mapping.map_state import MapArrays
from neural_graph_mapping_tpu_torch.run_mapping import NeuralGraphMapRunner
from neural_graph_mapping_tpu_torch.utils import transforms
from neural_graph_mapping_tpu_torch.utils.observability import RerunLogger


def edit_fields(map_arrays: MapArrays, edits: Sequence[dict], num_fields: int) -> MapArrays:
    """Apply field-pose edits to the map arrays (on their device).

    Each edit dict supports:
      - ``field_id`` + ``position`` (3,): set one field's position;
      - ``field_id``/``field_ids`` + ``translate`` (3,): shift position(s);
      - ``field_id``/``field_ids`` + ``transform`` (4, 4): rigid transform of
        position AND orientation (what loop-closure re-anchoring does).

    Returns new map arrays with updated positions / orientations.
    """
    positions = map_arrays.positions.detach().cpu().numpy().copy()
    orientations = map_arrays.orientations.detach().cpu().numpy().copy()
    for edit in edits:
        ids = edit.get("field_ids")
        if ids is None:
            ids = [edit["field_id"]]
        ids = np.asarray(ids, np.int64)
        if (ids < 0).any() or (ids >= num_fields).any():
            raise ValueError(f"edit targets out-of-range field ids {ids}")
        if "position" in edit:
            if ids.shape[0] != 1:
                raise ValueError("'position' edit targets exactly one field")
            positions[ids[0]] = np.asarray(edit["position"], np.float32)
        elif "translate" in edit:
            positions[ids] += np.asarray(edit["translate"], np.float32)
        elif "transform" in edit:
            t = np.asarray(edit["transform"], np.float32)
            positions[ids] = positions[ids] @ t[:3, :3].T + t[:3, 3]
            orientations[ids] = transforms.transform_quaternions(
                torch.from_numpy(orientations[ids]), torch.from_numpy(t)
            ).numpy()
        else:
            raise ValueError(f"edit needs position/translate/transform: {edit}")
    dev = map_arrays.positions.device
    return map_arrays._replace(
        positions=torch.from_numpy(positions).to(dev),
        orientations=torch.from_numpy(orientations).to(dev),
    )


def main(argv: Optional[List[str]] = None) -> Tuple[NeuralGraphMapRunner, Dict[int, torch.Tensor]]:
    """Load, edit, render and save -> (the runner holding the edited map,
    {frame id: rendered rgbd}). The keyframe cache is not allocated: a map
    checkpoint needs none to render, and a full one brings its own."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    config = config_mod.load_config_from_args(rest)
    runner = NeuralGraphMapRunner(config, device=known.device)
    dataset_type = config_mod.str_to_object(config["dataset_type"])
    dataset = dataset_type(config.get("dataset_config", {}))
    dataset.load_slam_results()
    runner.dataset = dataset
    runner.engine._camera = dataset.camera
    runner.load_model(config["model"])

    e = runner.engine
    edits = config.get("edits") or []
    if edits:
        e._map_arrays = edit_fields(e._map_arrays, edits, e.num_fields)
        print(f"applied {len(edits)} field edit(s)")

    rrl = RerunLogger("ngm_checkpoint_vis")
    positions = e._map_arrays.positions[: e.num_fields].cpu().numpy()
    if rrl.enabled:
        rrl.log_fields(positions, e._field_radius)

    renders = {}
    for frame_id in config.get("frames", [0]):
        c2w = dataset.get_slam_c2ws(frame_id, len(dataset) - 1)
        rgbd, _ = e.render_image(c2w, dataset.camera)
        renders[frame_id] = rgbd
        rrl.set_frame(frame_id)
        rrl.log_camera(c2w, dataset.camera, rgbd.cpu().numpy(), name=f"render_{frame_id}")
        print(f"rendered frame {frame_id}: depth mean {float(rgbd[..., 3].mean()):.2f} m")

    if config.get("save"):
        out = runner.save_model(config["save"])
        print(f"saved edited checkpoint to {out}")
    return runner, renders


if __name__ == "__main__":
    main()
