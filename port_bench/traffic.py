"""The traffic of the stream and render cells: a lap of the scene served
as a SLAM dataset, and every random draw of a frame made from the seed.

Both the program and the reference are handed the same objects' output:
the same frames, poses, pose graph and draws. Neither the dataset nor the
draw source imports the program; each map is given a camera of its own
package.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from port_bench.reference.ngm.mapping import map_state
from port_bench.reference.ngm.models.fields import NeuralFieldSet

CLOUD_POINTS = 50_000  # single-view depth cloud


class LapDataset:
    """The SLAM-dataset side of ``datasets/base.SLAMDataset`` that
    ``NeuralGraphMap.process_frame`` reads: ground-truth poses of a lap
    that repeats past its end (frame ``f`` is lap pose ``(phase + f) % N``),
    a keyframe every ``keyframe_every`` frames, and the fully connected
    fixed-frequency pose graph of ``SLAMDataset._create_fixed_kf_freq_pg_dict``,
    one dict object from one keyframe to the next."""

    def __init__(self, camera, poses: np.ndarray, phase: int, keyframe_every: int) -> None:
        self.camera = camera
        self._poses = poses
        self._phase = int(phase)
        self._every = int(keyframe_every)
        self._graph_kf = -1
        self._graph: dict = {}

    def pose_index(self, frame_id: int) -> int:
        return (self._phase + int(frame_id)) % len(self._poses)

    def get_slam_c2ws(self, frame_id: int, at_frame_id: Optional[int] = None) -> np.ndarray:
        return self._poses[self.pose_index(frame_id)]

    def is_keyframe(self, frame_id: int, at_frame_id: Optional[int] = None) -> bool:
        return frame_id % self._every == 0

    def slam_poses_dirty(self, frame_id: int) -> bool:
        return False  # ground-truth poses never move

    def get_slam_essential_graph(self, at_frame_id: int) -> dict:
        last_kf = at_frame_id - at_frame_id % self._every
        if last_kf != self._graph_kf:
            kfs = range(0, last_kf + 1, self._every)
            self._graph = {kf: set(kfs) for kf in kfs}
            self._graph_kf = last_kf
        return self._graph


def lap_dataset(camera, poses: np.ndarray, phase: int, scene: dict) -> LapDataset:
    """The pose source of a scene, for the program and the reference alike:
    ground truth. A scene that asks for a SLAM stream (a ``slam`` block) is
    refused: the harness has no such source."""
    if "slam" in scene:
        raise ValueError("a scene with a slam block: the harness serves ground-truth poses only")
    return LapDataset(camera, poses, phase, int(scene["keyframe_every"]))


class Draws(NamedTuple):
    """One iteration's draws under the names ``engine.IterationDraws`` gives
    them (the map reads them by name)."""

    u_obs: Optional[torch.Tensor] = None
    u_rand: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    kf_gumbel: Optional[torch.Tensor] = None
    pix_u: Optional[torch.Tensor] = None
    u_coarse: Optional[torch.Tensor] = None
    u_guided: Optional[torch.Tensor] = None
    slot_gumbel: Optional[torch.Tensor] = None
    cloud_idx: Optional[torch.Tensor] = None
    u_fields: Optional[torch.Tensor] = None
    u_rays: Optional[torch.Tensor] = None


def stream_seed(seed: int, *key) -> int:
    """A 63-bit generator seed for (seed, key...): any whole seed, however large."""
    digest = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.clamp(torch.rand(shape, generator=gen, device=device), min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class SeededDraws:
    """Every random draw of a map (``engine.DrawSource``'s methods), made on
    the device from (seed, kind, frame counter or call, iteration). Two
    sources of one seed and model config hand two maps the same tensors.
    Field init is the frozen copy's ``NeuralFieldSet.init_fields``."""

    def __init__(self, seed: int, map_config: dict, device) -> None:
        self._seed = int(seed)
        self._device = torch.device(device)
        self._fset = NeuralFieldSet(**map_config["model_kwargs"])
        self._cell = map_state.field_cell_size(float(map_config.get("field_radius", 1.0)))
        self._init_calls = 0
        self._sv_calls = 0

    def _gen(self, *key) -> torch.Generator:
        return torch.Generator(self._device).manual_seed(stream_seed(self._seed, *key))

    def init_fields(self, num_fields: int) -> dict:
        self._init_calls += 1
        return self._fset.init_fields(num_fields, self._gen("init", self._init_calls), self._device)

    def allocation_shift(self, frame_counter: int) -> torch.Tensor:
        return torch.rand(3, generator=self._gen("shift", frame_counter), device=self._device) * self._cell

    def observed_gumbel(self, frame_counter: int, shapes, num_points: int) -> torch.Tensor:
        return _gumbel((num_points, shapes.height * shapes.width), self._gen("observed", frame_counter),
                       self._device)

    def multi_view(self, frame_counter: int, num_iters: int, sh) -> list:
        out, dev = [], self._device
        f, r = sh.num_train_fields, sh.num_rays
        for i in range(num_iters):
            g = self._gen("mv", frame_counter, i)
            out.append(Draws(
                u_obs=torch.rand(sh.capacity, generator=g, device=dev),
                u_rand=torch.rand(sh.capacity, generator=g, device=dev),
                offsets=torch.randn((20, 3), generator=g, device=dev),
                kf_gumbel=_gumbel((f, r, sh.num_slots), g, dev),
                pix_u=torch.rand((f, r, 2), generator=g, device=dev),
                u_coarse=torch.rand((f, r, sh.num_coarse), generator=g, device=dev),
                u_guided=torch.rand((f, r, sh.num_guided), generator=g, device=dev),
            ))
        return out

    def single_view(self, num_iters: int, sh, cache_depth: torch.Tensor, cache_valid: torch.Tensor) -> list:
        """Iteration i trains on the view the map picks from ``slot_gumbel``
        (the current frame on odd iterations, if valid); its cloud is drawn
        among that view's valid depth pixels by inverse CDF, on the device,
        so the draws need no host sync."""
        self._sv_calls += 1
        out, dev = [], self._device
        f, r = sh.num_train_fields, sh.num_rays
        others = torch.cat([torch.zeros_like(cache_valid[:1]), cache_valid[1:]])
        for i in range(num_iters):
            g = self._gen("sv", self._sv_calls, i)
            slot_gumbel = _gumbel(cache_valid.shape, g, dev)
            random_slot = torch.argmax(slot_gumbel + torch.where(others, 0.0, -torch.inf))
            slot = torch.where(cache_valid[0] & (i % 2 != 0), 0, random_slot).reshape(1)
            valid = cache_depth.index_select(0, slot)[0].reshape(-1) != 0.0
            cdf = torch.cumsum(valid.to(torch.float32), 0)
            u = torch.rand(CLOUD_POINTS, generator=g, device=dev) * cdf[-1]
            cloud_idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, valid.numel() - 1)
            out.append(Draws(
                slot_gumbel=slot_gumbel,
                cloud_idx=cloud_idx,
                u_fields=torch.rand(sh.capacity, generator=g, device=dev),
                u_rays=torch.rand((f, r), generator=g, device=dev),
                u_coarse=torch.rand((f, r, sh.num_coarse), generator=g, device=dev),
                u_guided=torch.rand((f, r, sh.num_guided), generator=g, device=dev),
            ))
        return out
