"""Abstract SLAM dataset: RGB-D sequences + precomputed sparse-SLAM results
(port of neural_graph_mapping_tpu.datasets.base; numpy host code).

Host-side (numpy) rebuild of the reference ``slam_dataset.py``. A dataset
provides:

- per-frame samples ``{"time", "rgbd" (H, W, 4 float32), "c2w" (4, 4)}``
  (RGB in [0,1], depth in meters, OpenGL camera convention);
- SLAM results: per-frame camera-to-world estimates *as of* a given frame
  (``get_slam_c2ws``), the essential pose graph per frame
  (``get_slam_essential_graph``), keyframe membership, and the final
  trajectory; all either parsed from ORB-SLAM2 JSON exports
  (slam_dataset.py:424-576) or synthesized from ground truth
  (pose_source="gt" + pg_source="fixed_kf_freq", slam_dataset.py:407-422 —
  the reference's mechanism for running without a SLAM system);
- trajectory alignment (Umeyama, replacing `evo`) and scene bounds.

Parsed SLAM results are cached next to the source files as ``.npz``
(the reference caches ``.pt``, slam_dataset.py:439-443).
"""

from __future__ import annotations

import abc
import json
import logging
import os
import pathlib
import pickle
from typing import Dict, List, Literal, Optional, Set

import numpy as np

import torch

from neural_graph_mapping_tpu_torch import camera as camera_mod
from neural_graph_mapping_tpu_torch.mapping import graph as graph_mod
from neural_graph_mapping_tpu_torch.utils import transforms

logger = logging.getLogger(__name__)

# OpenCV <-> OpenGL camera-frame flip (slam_dataset.py:637-645)
OGL2OCV = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def pose_vector_to_4x4(pose_vector) -> np.ndarray:
    """x y z qx qy qz qw -> OpenGL c2w 4x4 (slam_dataset.py:626-645)."""
    from scipy.spatial.transform import Rotation

    v = np.asarray(pose_vector, dtype=np.float64)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = Rotation.from_quat(v[3:7]).as_matrix().astype(np.float32)
    m[:3, 3] = v[:3].astype(np.float32)
    return m @ OGL2OCV


def pg_records_to_essential_graph(
    records: List[dict], weight_threshold: float
) -> Dict[int, Set[int]]:
    """ORB-SLAM2 pose-graph records {KF, LC, CV, WGT} -> essential graph
    (slam_dataset.py:648-667): loop-closure edges plus covisibility edges
    above the weight threshold, restricted to live vertices."""
    graph: Dict[int, Set[int]] = {rec["KF"]: set() for rec in records}
    for rec in records:
        edges = set(rec.get("LC", []))
        edges |= {
            to for to, wgt in zip(rec.get("CV", []), rec.get("WGT", [])) if wgt > weight_threshold
        }
        graph[rec["KF"]] = edges & graph.keys()
    return graph


class SLAMDataset(abc.ABC):
    """Abstract SLAM dataset (reference slam_dataset.py:87)."""

    default_config: dict = {
        "slam_final_file": None,
        "slam_c2w_file": None,
        "slam_pg_file": None,
        "slam_essential_weight_threshold": 10,
        "up_axis": None,
        "pose_source": "slam",  # "slam" | "gt"
        "pg_source": "slam",  # "slam" | "fixed_kf_freq"
        "fixed_kf_freq": 5,
        "prefetch": False,  # cache decoded frames in memory (ref :60-61)
    }

    camera: camera_mod.Camera
    gt_c2ws: Optional[np.ndarray]  # (N, 4, 4) or None
    slam_final_c2ws: Optional[np.ndarray]

    def __init__(self, config: dict) -> None:
        merged = dict(self.default_config)
        merged.update(config or {})
        self.config = merged
        self.root_dir_path = pathlib.Path(os.path.expanduser(str(merged.get("root_dir", "."))))
        self.scene = merged.get("scene", "")
        self.up_axis = merged.get("up_axis")
        self._weight_threshold = merged["slam_essential_weight_threshold"]
        self._pose_source = merged["pose_source"]
        self._pg_source = merged["pg_source"]
        self._fixed_kf_freq = int(merged["fixed_kf_freq"])
        assert self._pose_source in ("gt", "slam")
        assert self._pg_source in ("fixed_kf_freq", "slam")

        self.gt_c2ws = None
        self.slam_final_c2ws = None
        self._slam_c2w_dict: Optional[Dict[int, Dict[int, np.ndarray]]] = None
        self._slam_pg_dict: Optional[Dict[int, Dict[int, Set[int]]]] = None
        self.slam_online_c2ws: Optional[np.ndarray] = None
        self._slam_poses_dirty_flags: Optional[np.ndarray] = None

    # -- abstract surface (per-dataset loaders implement) ----------------------

    @staticmethod
    @abc.abstractmethod
    def get_available_scenes(root_dir: str) -> List[str]:
        """Scenes available under a root directory."""

    @property
    @abc.abstractmethod
    def num_images(self) -> int:
        """Number of frames in the sequence."""

    @property
    @abc.abstractmethod
    def scene_dir_path(self) -> pathlib.Path:
        """Directory of the current scene."""

    @abc.abstractmethod
    def _get_sequence_item(self, index: int) -> dict:
        """Return {"time", "rgbd", "c2w"} for a frame."""

    def set_mode(self, mode: Literal["ray", "sequence"]) -> None:
        """Switch between per-frame and per-ray indexing
        (slam_dataset.py:322-330; ray mode is what the reference's vis
        tooling consumes). In ray mode ``len`` is num_images * H * W and
        items are ``{"ij" (2,), "rgbd" (4,), "c2w" (4, 4)}``; frames are
        decoded lazily with a one-frame memo (instead of the reference's
        full prefetch) since consumers scan rays in frame order."""
        if mode not in ("ray", "sequence"):
            raise ValueError(f"Unknown dataset mode {mode!r}")
        self._mode = mode

    def __getitem__(self, index: int) -> dict:
        if getattr(self, "_mode", "sequence") == "sequence":
            if self.config.get("prefetch"):
                # in-memory frame cache (reference nrgbd_dataset.py:60-61,
                # :179): decode each frame once, serve from memory after
                cache = getattr(self, "_prefetch_cache", None)
                if cache is None:
                    cache = self._prefetch_cache = {}
                if index not in cache:
                    cache[index] = self._get_sequence_item(index)
                return cache[index]
            return self._get_sequence_item(index)
        rays_per_frame = self.camera.height * self.camera.width
        frame_id, pix = divmod(index, rays_per_frame)
        i, j = divmod(pix, self.camera.width)
        if getattr(self, "_ray_memo_id", None) != frame_id:
            self._ray_memo_id = frame_id
            self._ray_memo = self._get_sequence_item(frame_id)
        item = self._ray_memo
        return {
            "ij": np.asarray([i, j], np.float32),
            "rgbd": item["rgbd"][i, j],
            "c2w": item["c2w"],
        }

    def __len__(self) -> int:
        if getattr(self, "_mode", "sequence") == "ray":
            return self.num_images * self.camera.height * self.camera.width
        return self.num_images

    def __str__(self) -> str:
        return f"{self.__class__.__name__}_{self.scene}"

    @property
    def has_gt_mesh(self) -> bool:
        return False

    @property
    def gt_mesh_path(self) -> pathlib.Path:
        raise NotImplementedError()

    def load_gt_mesh(self):
        raise NotImplementedError()

    # -- SLAM results ------------------------------------------------------------

    def load_slam_results(self) -> None:
        """Populate SLAM-result state per pose/pg source (slam_dataset.py:382-405)."""
        if self._pose_source == "slam" and self.config.get("slam_c2w_file"):
            self._load_slam_c2w_file()
        elif self._pose_source == "gt":
            if self.gt_c2ws is None:
                raise ValueError("pose_source='gt' requires ground-truth poses.")
            self.slam_online_c2ws = self.gt_c2ws
            self._slam_c2w_dict = None  # gt mode answers queries directly

        if self._pg_source == "slam" and self.config.get("slam_pg_file"):
            self._load_slam_pg_file()
        elif self._pg_source == "fixed_kf_freq":
            self._create_fixed_kf_freq_pg_dict()

        if self._pose_source == "slam" and self.config.get("slam_final_file"):
            self._load_slam_final_file()
        elif self._pose_source == "gt":
            self.slam_final_c2ws = self.gt_c2ws

    def get_slam_c2ws(
        self, frame_id: Optional[int] = None, at_frame_id: Optional[int] = None
    ):
        """c2w of ``frame_id`` as estimated at ``at_frame_id``
        (slam_dataset.py:332-359). NaN matrix if unavailable."""
        assert not (frame_id is None and at_frame_id is None)
        if at_frame_id is None:
            at_frame_id = frame_id
        if self._pose_source == "gt":
            if frame_id is None:
                return {i: self.gt_c2ws[i] for i in range(self.num_images)}
            return self.gt_c2ws[frame_id]
        frames = self._slam_c2w_dict[at_frame_id]
        if frame_id is None:
            return frames
        return frames.get(frame_id, np.full((4, 4), np.nan, np.float32))

    def get_slam_essential_graph(self, at_frame_id: int) -> Dict[int, Set[int]]:
        return self._slam_pg_dict[at_frame_id]

    def is_keyframe(self, frame_id: int, at_frame_id: Optional[int] = None) -> bool:
        if at_frame_id is None:
            at_frame_id = frame_id
        return frame_id in self._slam_pg_dict[at_frame_id]

    def slam_poses_dirty(self, frame_id: int) -> bool:
        """Whether any keyframe pose at ``frame_id`` may differ from its pose
        at ``frame_id - 1``.

        Engine fast path (engine._update_graph): when this returns False the
        per-frame O(keyframes) pose snapshot + loop-closure delta check can be
        skipped entirely. GT poses are static by definition; SLAM mode
        precomputes one boolean per frame from the parsed c2w history (the
        reference re-reads every keyframe pose every frame —
        run_mapping.py:937-952 — which is exactly the host cost we avoid).
        """
        if self._pose_source == "gt":
            return False
        if self._slam_c2w_dict is None:
            return True
        if self._slam_poses_dirty_flags is None:
            self._compute_slam_poses_dirty()
        if 0 <= frame_id < len(self._slam_poses_dirty_flags):
            return bool(self._slam_poses_dirty_flags[frame_id])
        return True

    def _compute_slam_poses_dirty(self) -> None:
        """One pass over the c2w history marking frames where any keyframe
        pose changed vs the previous frame (the frames' own "cur" entries are
        excluded — slot 0 is handled separately by the engine)."""
        n = self.num_images
        flags = np.ones((n,), bool)
        prev: Optional[Dict[int, np.ndarray]] = None
        for i in range(n):
            cur = self._slam_c2w_dict.get(i, {})
            if prev is not None:
                ids = (set(cur.keys()) | set(prev.keys())) - {i, i - 1}
                flags[i] = any(
                    fid not in cur
                    or fid not in prev
                    or not np.array_equal(cur[fid], prev[fid], equal_nan=True)
                    for fid in ids
                )
            prev = cur
        self._slam_poses_dirty_flags = flags

    def _create_fixed_kf_freq_pg_dict(self) -> None:
        """Fully-connected fixed-frequency pose graph from frame indices
        (slam_dataset.py:407-422) — the synthetic/no-SLAM test path."""
        self._slam_pg_dict = {}
        kf_ids: Set[int] = set()
        latest: Dict[int, Set[int]] = {}
        for frame_id in range(self.num_images):
            if frame_id % self._fixed_kf_freq == 0:
                kf_ids.add(frame_id)
                latest = {kf: set(kf_ids) for kf in kf_ids}
            self._slam_pg_dict[frame_id] = latest

    def _load_slam_c2w_file(self) -> None:
        """Parse the per-frame c2w history JSON (slam_dataset.py:484-547)."""
        path = self._resolve_slam_file(self.config["slam_c2w_file"])
        cache = path.with_name("slam_c2w_dict.npz.pkl")
        if cache.is_file():
            with open(cache, "rb") as f:
                data = pickle.load(f)
            self._slam_c2w_dict = data["c2w_dict"]
            self.slam_online_c2ws = data["online"]
            return

        with open(path) as f:
            c2w_data = json.load(f)

        online = np.full((self.num_images, 4, 4), np.nan, np.float32)
        c2w_dict: Dict[int, Dict[int, np.ndarray]] = {}
        for at_frame_id in range(self.num_images):
            frames: Dict[int, np.ndarray] = {}
            entry = c2w_data.get(str(at_frame_id), {})
            for frame_str, pose_vector in entry.items():
                c2w = pose_vector_to_4x4(pose_vector)
                if frame_str == "cur":
                    online[at_frame_id] = c2w
                    fid = at_frame_id
                else:
                    fid = int(frame_str)
                if fid not in frames:
                    frames[fid] = c2w
            if at_frame_id not in frames:
                frames[at_frame_id] = np.full((4, 4), np.nan, np.float32)
            c2w_dict[at_frame_id] = frames

        self._slam_c2w_dict = c2w_dict
        self.slam_online_c2ws = online
        with open(cache, "wb") as f:
            pickle.dump({"c2w_dict": c2w_dict, "online": online}, f)

    def _load_slam_pg_file(self) -> None:
        """Parse the pose-graph JSON (slam_dataset.py:424-471)."""
        path = self._resolve_slam_file(self.config["slam_pg_file"])
        cache = path.with_name("slam_pg_dict.pkl")
        if cache.is_file():
            with open(cache, "rb") as f:
                self._slam_pg_dict = pickle.load(f)
            return

        with open(path) as f:
            pg_data = json.load(f)

        self._slam_pg_dict = {}
        latest_graph: Dict[int, Set[int]] = {}
        for at_frame_id in range(self.num_images):
            records = pg_data.get(str(at_frame_id))
            if records is not None and any(r["KF"] == at_frame_id for r in records):
                latest_graph = pg_records_to_essential_graph(
                    records, self._weight_threshold
                )
            # drop keyframes whose pose is unknown at this frame (:461-467)
            known = set(self._slam_c2w_dict[at_frame_id].keys())
            graph = latest_graph
            for vertex in list(graph.keys()):
                if vertex not in known:
                    graph = graph_mod.remove_vertex(graph, vertex)
            self._slam_pg_dict[at_frame_id] = graph

        with open(cache, "wb") as f:
            pickle.dump(self._slam_pg_dict, f)

    def _load_slam_final_file(self) -> None:
        """Final trajectory txt: rows of [id] x y z qx qy qz qw
        (slam_dataset.py:549-576)."""
        path = self._resolve_slam_file(self.config["slam_final_file"])
        results = np.loadtxt(path)
        has_pose = np.isfinite(self.slam_online_c2ws.reshape(-1, 16)).all(axis=-1)
        frame_of_row = np.arange(self.num_images)[has_pose]
        c2ws = np.full((self.num_images, 4, 4), np.nan, np.float32)
        for i, row in enumerate(results):
            if i >= len(frame_of_row):
                break
            c2ws[frame_of_row[i]] = pose_vector_to_4x4(row[1:8])
        self.slam_final_c2ws = c2ws

    def _resolve_slam_file(self, filepath) -> pathlib.Path:
        p = pathlib.Path(os.path.expanduser(str(filepath)))
        if p.is_absolute():
            return p
        for base in (self.scene_dir_path, pathlib.Path(".")):
            candidate = base / p
            if candidate.is_file():
                return candidate
        return self.scene_dir_path / p

    # -- alignment / bounds ---------------------------------------------------------

    def gt_from_est_transform(
        self, alignment_method: Literal["origin", "umeyama"] = "umeyama"
    ) -> np.ndarray:
        """Align the final SLAM trajectory to ground truth
        (slam_dataset.py:282-319); replaces `evo` with our Umeyama."""
        if self.slam_final_c2ws is None:
            raise ValueError("final estimated trajectory is not available")
        if self.gt_c2ws is None:
            raise ValueError("ground-truth trajectory is not available")
        gt_ok = np.isfinite(self.gt_c2ws.reshape(-1, 16)).all(-1)
        est_ok = np.isfinite(self.slam_final_c2ws.reshape(-1, 16)).all(-1)
        mask = gt_ok & est_ok
        if mask.sum() < 3:
            raise ValueError("not enough valid poses to align")
        gt_pos = self.gt_c2ws[mask][:, :3, 3]
        est_pos = self.slam_final_c2ws[mask][:, :3, 3]
        if alignment_method == "umeyama":
            return transforms.umeyama_alignment(est_pos, gt_pos).astype(np.float32)
        if alignment_method == "origin":
            first = np.argmax(mask)
            return (
                self.gt_c2ws[first] @ np.linalg.inv(self.slam_final_c2ws[first])
            ).astype(np.float32)
        raise ValueError(f"Unknown {alignment_method=}")

    @property
    def scene_bounds(self) -> Optional[np.ndarray]:
        """Tight scene AABB from backprojected gt-posed depth
        (slam_dataset.py:579-618). Computed on every call: the port keeps
        no ``scene_bounds.txt`` cache beside the scene."""
        if self.gt_c2ws is None:
            return None
        aabb_min = np.full((3,), np.inf)
        aabb_max = np.full((3,), -np.inf)
        for i in range(self.num_images):
            if not np.isfinite(self.gt_c2ws[i]).all():
                continue
            item = self[i]
            depth = np.asarray(item["rgbd"][..., 3])
            pts, _, valid = self.camera.depth_to_points_full(torch.from_numpy(depth), "opengl")
            pts = pts.numpy()[valid.numpy()]
            if len(pts) == 0:
                continue
            pts_w = pts @ self.gt_c2ws[i][:3, :3].T + self.gt_c2ws[i][:3, 3]
            aabb_min = np.minimum(aabb_min, pts_w.min(axis=0))
            aabb_max = np.maximum(aabb_max, pts_w.max(axis=0))
        return np.stack([aabb_min, aabb_max]).astype(np.float32)

    @property
    def custom_scene_bounds(self) -> Optional[np.ndarray]:
        return None
