"""Experiment logging + streaming 3D telemetry (wandb / rerun), gated (port
of neural_graph_mapping_tpu.utils.observability).

Rebuild of the reference's observability stack: a wandb run per fit with the
flattened config and BrokenPipe-tolerant logging (run_mapping.py:72-79,
1036-1049; utils.prepare_dict_for_wandb utils.py:254-267), and rerun 3D
streaming of field centers, camera poses, RGB-D frames, and meshes
(run_mapping.py:2022-2126; utils.rr_init utils.py:17-38).

Both backends are optional host-side dependencies: every entry point
degrades to a no-op (with one warning) when the package is missing, so the
mapping pipeline never depends on telemetry. Unlike the JAX package, wandb
is opt-in (``WandbLogger(..., enabled=True)``, the ``wandb: true`` config
key): an installed wandb without credentials fails in ``wandb.init``, and
its error reporting then tries to reach its own servers, so the port never
imports it unless asked to.
"""

from __future__ import annotations

import copy
import logging
from typing import Literal, Optional

import numpy as np

logger = logging.getLogger(__name__)


def prepare_dict_for_wandb(x: dict) -> dict:
    """Recursively convert numpy / torch scalars to base python types
    (reference utils.py:254-267)."""
    x = copy.deepcopy(x)
    for key in list(x.keys()):
        v = x[key]
        if isinstance(v, dict):
            x[key] = prepare_dict_for_wandb(v)
        elif hasattr(v, "item"):
            try:
                x[key] = v.item()
            except Exception:
                x[key] = str(v)
        elif isinstance(v, float):
            x[key] = float(v)
        elif isinstance(v, int):
            x[key] = int(v)
    return x


class WandbLogger:
    """wandb run wrapper; a no-op unless ``enabled``, and when wandb is
    unavailable."""

    def __init__(
        self, project: str, config: dict, name: Optional[str] = None, enabled: bool = False
    ) -> None:
        self._run = None
        self._wandb = None
        if not enabled:
            return
        try:
            import wandb

            self._wandb = wandb
            self._run = wandb.init(
                project=project, config=prepare_dict_for_wandb(config), name=name
            )
        except (ImportError, AttributeError):
            # AttributeError: a stray ``wandb/`` artifact directory on the
            # path imports as an empty namespace package without ``init``
            logger.warning("wandb not installed; experiment logging disabled")
            self._wandb = None
            self._run = None

    @property
    def enabled(self) -> bool:
        return self._run is not None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if self._run is None:
            return
        try:  # BrokenPipe-guarded like the reference (run_mapping.py:72-79)
            self._wandb.log(metrics, step=step)
        except BrokenPipeError:
            logger.warning("logging to wandb failed (BrokenPipeError)")

    def log_image(self, key: str, image, step: Optional[int] = None) -> None:
        """Push a render-preview image (reference run_mapping.py:1901-1903
        wandb.Image of the matplotlib preview grid)."""
        if self._run is None:
            return
        try:
            self._wandb.log({key: self._wandb.Image(image)}, step=step)
        except BrokenPipeError:
            logger.warning("logging image to wandb failed (BrokenPipeError)")

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()


def rr_up_axis(up_axis: Literal["x", "y", "z", "-x", "-y", "-z"]):
    """Convert a SLAMDataset up-axis to rerun view coordinates
    (reference utils.py:41-58)."""
    import rerun as rr

    return {
        "x": rr.ViewCoordinates.RIGHT_HAND_X_UP,
        "y": rr.ViewCoordinates.RIGHT_HAND_Y_UP,
        "z": rr.ViewCoordinates.RIGHT_HAND_Z_UP,
        "-x": rr.ViewCoordinates.RIGHT_HAND_X_DOWN,
        "-y": rr.ViewCoordinates.RIGHT_HAND_Y_DOWN,
        "-z": rr.ViewCoordinates.RIGHT_HAND_Z_DOWN,
    }[up_axis]


class RerunLogger:
    """Streaming 3D telemetry via rerun; no-op if unavailable.

    Mirrors the reference's entity layout: ``slam/fields`` (points),
    ``slam/camera`` (+ pinhole image with RGB and depth), ``mesh``.
    """

    def __init__(
        self,
        application_id: str = "neural_graph_mapping_tpu_torch",
        rrd_path: Optional[str] = None,
        connect_addr: Optional[str] = None,
        spawn: bool = True,
    ) -> None:
        self._rr = None
        try:
            import rerun as rr

            rr.init(application_id)
            if rrd_path is not None:
                rr.save(rrd_path)
            elif connect_addr is not None:
                rr.connect(connect_addr)
            elif spawn:
                rr.spawn()
            self._rr = rr
        except ImportError:
            logger.warning("rerun-sdk not installed; 3D telemetry disabled")

    @property
    def enabled(self) -> bool:
        return self._rr is not None

    def set_frame(self, frame_id: int) -> None:
        if self._rr:
            self._rr.set_time_sequence("frame_id", frame_id)

    def log_fields(
        self, positions: np.ndarray, radius: float, active_mask=None
    ) -> None:
        if not self._rr:
            return
        class_ids = None
        if active_mask is not None:
            class_ids = np.asarray(active_mask).astype(np.int32)
        self._rr.log(
            "slam/fields",
            self._rr.Points3D(
                np.asarray(positions), radii=radius * 0.05, class_ids=class_ids
            ),
        )

    def log_camera(self, c2w: np.ndarray, camera, rgbd=None, name: str = "camera") -> None:
        if not self._rr:
            return
        rr = self._rr
        c2w = np.asarray(c2w)
        # OpenGL c2w -> rerun expects the OpenCV-style child frame
        ocv = c2w.copy()
        ocv[:3, 1] *= -1
        ocv[:3, 2] *= -1
        rr.log(
            f"slam/{name}",
            rr.Transform3D(translation=ocv[:3, 3], mat3x3=ocv[:3, :3]),
        )
        rr.log(
            f"slam/{name}/image",
            rr.Pinhole(
                image_from_camera=np.asarray(camera.get_projection_matrix()),
                width=camera.width,
                height=camera.height,
            ),
        )
        if rgbd is not None:
            rgbd = np.asarray(rgbd)
            rr.log(f"slam/{name}/image/rgb", rr.Image(rgbd[..., :3]))
            rr.log(f"slam/{name}/image/depth", rr.DepthImage(rgbd[..., 3], meter=1.0))

    def log_mesh(self, mesh) -> None:
        if not self._rr:
            return
        self._rr.log(
            "mesh",
            self._rr.Mesh3D(
                vertex_positions=mesh.vertices,
                triangle_indices=mesh.faces,
                vertex_colors=mesh.vertex_colors,
            ),
        )
