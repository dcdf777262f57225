"""A whole online run of the port in lockstep with the JAX package's, on the
CPU: JAX's ``NeuralGraphMap`` and the port's side by side, frame by frame,
the port fed every draw JAX makes (``engine.DrawSource``, replayed key for
key by :class:`JaxReplay`), so the two runs are one deterministic
computation done twice and any gap points at the frame and the quantity
where it starts.

Cases (64x48, the tiny model of ``tests/test_torch_engine.py``):

- ``growth``: the synthetic scene, ``gt`` poses, ``fixed_kf_freq``
  keyframes, 12 frames; the field capacity grows from 32 to 128.
- ``loop_closure``: a Replica-layout scene whose ORB-SLAM2 files drift and
  then close a loop that drops a keyframe (``chip_smoke.write_slam_files``),
  so ``_update_graph`` re-anchors fields and moves them mid-run.
- ``single_view``: ``update_mode: single_view``.
- ``nrgbd``: the synthetic scene written by the port's NRGBD exporter
  (``scripts/export_synthetic_nrgbd.py``) and read back by each package's
  own NRGBD loader with config/fps960.yaml's ``dataset_config`` (the root
  replaced, the camera scaled to 64x48: fx 56, cx 32, cy 24, pixel_center
  0.0 as the YAML has it), 12 frames: the long-sequence configuration's
  path at the tiny size.

Held after every frame:

- exactly: ``num_fields``, capacity, ``_kf2fields``, the keyframe slots
  (``_frame_to_slot``, the cache's valid slots, each field's ``kf_ids`` /
  ``kf_slots``), the observed mask, ``training_iterations`` and the Adam
  step counts; the cached poses and field positions / orientations within
  1e-5;
- the frame's losses within rtol 1e-4 (atol 1e-7, for terms at 0);
- JAX's settled Adam write-back divergence (ROADMAP section 3) kept out:
  JAX writes every training slot back, so an invalid slot whose field id
  is also trained by a valid slot of the same iteration (multi-view
  selection points invalid slots at field 0; single-view ids of invalid
  slots are arbitrary) overwrites that field's update with its stale copy,
  where the port writes valid slots only. The spy names such fields per
  iteration and they leave the param comparison from then on; an invalid
  slot whose field no valid slot trains (a selected field no cached view
  sees) writes back the field's own values in JAX, so it stays compared;
- params and Adam moments *where the gradient is above a floor*: Adam's
  ``eps`` is 1e-15, so a step driven by a gradient that is only rounding
  noise (weight decay against a vanishing data gradient) is a full +-lr
  step whose sign is that noise, and the two packages may part there by
  O(lr) without a fault. ``chip_smoke.GradientFloor`` watches the port's
  Adam steps and counts, per element, the steps whose gradient (weight
  decay included) was below 1e-4 in magnitude. An element with none is
  held within 1e-4 (0.1 lr: over tens of steps a gradient summed in
  another order shifts each step by lr times its relative rounding); one
  with k such steps within 1e-4 plus k times the difference of two Adam
  steps, each at most lr (1 - b1) / sqrt(1 - b2) = 3.17 lr. Adam's first
  moments are held everywhere within 1e-3 of the leaf's largest gradient
  of the run, second moments within 2e-3 of its square
  (``chip_smoke.adam_state_gaps``;
  the smoke's trajectory phase holds the card to the CPU with it). What
  the params compute is held too: every frame's losses (above), and one
  render block of each package's final weights through the port, within
  1e-4.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch
from test_torch_engine import _replayed_draws, tiny_config

import chip_smoke
from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
from neural_graph_mapping_tpu.datasets.replica import ReplicaDataset as JaxReplica
from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping import map_state as jmap_state
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu_torch import config as tconfig
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.datasets.replica import ReplicaDataset
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, optimizer

LOSS_RTOL, LOSS_ATOL = chip_smoke.LOCKSTEP_LOSS_RTOL, chip_smoke.LOCKSTEP_LOSS_ATOL
POSE_ATOL = chip_smoke.LOCKSTEP_POSE_ATOL
RENDER_ATOL = 1e-4

SYNTH = {"num_frames": 12, "width": 64, "height": 48, "fx": 56.0, "fy": 56.0}
FULL_WIDTH_FRAMES = 10
LC_FRAME, LOST_FRAME = 8, 5


class JaxReplay(engine.DrawSource):
    """The JAX engine's draws, key for key, as tensors for the port:

    - ``_key`` (``PRNGKey(seed)``), split once per ``_next_key()``: field
      init at construction and at each growth (``engine.py:646``, ``:706``),
      and each single-view frame's scan key (``:1032``);
    - ``_base_key`` (``PRNGKey(seed + 1)``): a frame's key is
      ``fold_in(base, counter)`` split into ``k_obs`` / ``k_opt``
      (``:249-250``), iterations ``split(k_opt, num_iters)`` (``:200``),
      each in ``optimization_iteration``'s split order; the allocation key
      ``fold_in(base, 100000 + counter)`` (``:1063``);
    - ``categorical`` in ``observed_fields_mask`` is the argmax of Gumbel
      noise of shape (500, H * W) plus the logits (``sampling.py:119-122``);
      single-view frames turn the scan's keys into the port's cloud pixel
      indices, field uniforms and ray uniforms.
    """

    def __init__(self, cfg: dict):
        seed = int(cfg.get("seed", 0))
        self.key = jax.random.PRNGKey(seed)
        self.base = jax.random.PRNGKey(seed + 1)
        self.jfs = JaxFieldSet(**cfg["model_kwargs"])
        self._init = jax.jit(self.jfs.init_fields, static_argnums=1)  # the same draws, one program
        self.cell = jmap_state.field_cell_size(cfg["field_radius"])
        self.camera = None  # JAX's camera, for single-view cloud draws

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _frame_keys(self, counter: int):
        return jax.random.split(jax.random.fold_in(self.base, counter))

    def init_fields(self, num_fields):
        params = self._init(self._next_key(), num_fields)
        return interop.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")

    def allocation_shift(self, frame_counter):
        key = jax.random.fold_in(self.base, 100000 + frame_counter)
        return to_torch(jax.random.uniform(key, (3,), minval=0.0, maxval=self.cell))

    def observed_gumbel(self, frame_counter, shapes, num_points):
        k_obs, _ = self._frame_keys(frame_counter)
        return to_torch(jax.random.gumbel(k_obs, (num_points, shapes.height * shapes.width)))

    def multi_view(self, frame_counter, num_iters, sh):
        _, k_opt = self._frame_keys(frame_counter)
        shape = (sh.capacity, sh.num_train_fields, sh.num_rays, sh.num_slots, sh.num_coarse, sh.num_guided)
        return [_replayed_draws(k, *shape) for k in jax.random.split(k_opt, num_iters)]

    def single_view(self, num_iters, sh, cache_depth, cache_valid):
        valid_slots = to_np(cache_valid)
        out = []
        for i, sub in enumerate(jax.random.split(self._next_key(), num_iters)):
            k_slot, k_target, k_render = jax.random.split(sub, 3)
            gumbel = jax.random.gumbel(k_slot, valid_slots.shape)
            others = valid_slots.copy()
            others[0] = False
            if i % 2 and valid_slots[0]:
                slot = 0
            else:
                slot = int(np.argmax(np.asarray(gumbel) + np.where(others, 0.0, -np.inf)))
            k_cloud, k_fields, k_rays = jax.random.split(k_target, 3)
            _, _, valid = self.camera.depth_to_points_full(jnp.asarray(to_np(cache_depth[slot])), "opengl")
            cloud = jax.random.categorical(k_cloud, jnp.log(jnp.where(valid, 1.0, 1e-20)), shape=(50_000,))
            kr1, kr2 = jax.random.split(k_render)
            f, r = sh.num_train_fields, sh.num_rays
            out.append(engine.IterationDraws(
                slot_gumbel=to_torch(gumbel),
                cloud_idx=to_torch(cloud).long(),
                u_fields=to_torch(jax.random.uniform(k_fields, (sh.capacity,))),
                u_rays=to_torch(jax.random.uniform(k_rays, (f, r))),
                u_coarse=to_torch(jax.random.uniform(kr1, (f, r, sh.num_coarse))),
                u_guided=to_torch(jax.random.uniform(kr2, (f, r, sh.num_guided))),
            ))
        return out


class IterationSpy:
    """Records the port's training targets of every iteration (field ids and
    validity) through ``engine._optimization_iteration_core``."""

    def __init__(self, monkeypatch):
        self.targets = []
        orig = engine._optimization_iteration_core

        def spy(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *args, **kwargs):
            self.targets.append((to_np(target.field_ids), to_np(target.field_valid)))
            return orig(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *args, **kwargs)

        monkeypatch.setattr(engine, "_optimization_iteration_core", spy)


def _param_gaps(jm, tm, lr: float, excluded, floor) -> dict:
    """Params and Adam moments of the two maps on every field but
    ``excluded``, by ``chip_smoke.adam_state_gaps`` (raises past the
    tolerances; tight where ``floor`` saw every gradient pass it) -> the
    largest gaps per leaf."""
    keep = np.ones(jm.capacity, bool)
    keep[sorted(excluded)] = False
    want = {"params": {k: np.asarray(v) for k, v in jm._params.items()},
            "m": {k: np.asarray(v) for k, v in jm._adam.m.items()},
            "v": {k: np.asarray(v) for k, v in jm._adam.v.items()}, "steps": np.asarray(jm._adam.steps)}
    got = chip_smoke.map_adam_state(tm)
    shapes = {k: v.shape for k, v in want["params"].items()}
    by_floor = chip_smoke.params_by_floor(
        {**want, "steps": np.where(keep, want["steps"], 0)}, got, floor, shapes)
    return chip_smoke.adam_state_gaps(want, got, lr, floor, keep), by_floor


def _assert_same_frame(jm, tm, want: dict, got: dict, fid: int, single_view: bool) -> dict:
    assert tm.num_fields == jm.num_fields, fid
    assert tm.capacity == jm.capacity, fid
    assert tm._kf2fields == jm._kf2fields, fid
    assert tm._frame_to_slot == jm._frame_to_slot, fid
    assert tm._free_slots == jm._free_slots, fid
    np.testing.assert_array_equal(tm._cache_valid_np, jm._cache_valid_np)
    assert_close(jm._cache_c2w_np, tm._cache_c2w_np, atol=POSE_ATOL)
    ja, ta = jm._map_arrays, tm._map_arrays
    for name in ("kf_ids", "kf_slots", "training_iterations"):
        np.testing.assert_array_equal(to_np(getattr(ta, name)), np.asarray(getattr(ja, name)), err_msg=f"{fid} {name}")
    assert_close(ja.positions, ta.positions, atol=POSE_ATOL, err_msg=f"{fid} positions")
    assert_close(ja.orientations, ta.orientations, atol=POSE_ATOL, err_msg=f"{fid} orientations")
    if not single_view:
        np.testing.assert_array_equal(to_np(tm._observed_mask), np.asarray(jm._observed_mask))
    assert set(got) == set(want), fid
    for k in want:
        assert_close(want[k], got[k], atol=LOSS_ATOL, rtol=LOSS_RTOL, err_msg=f"frame {fid} {k}")
    rel = max((abs(want[k] - got[k]) / max(abs(want[k]), 1e-12) for k in want), default=0.0)
    return {"frame": fid, "fields": tm.num_fields, "capacity": tm.capacity, "loss_max_rel": rel,
            "positions_max_abs": float(np.abs(np.asarray(ja.positions) - to_np(ta.positions)).max())}


def _render_gap(tm, jm, ds) -> float:
    """One 256-ray render block of each map's weights through the port (the
    same positions and jitter): max abs difference of RGB-D."""
    jp = interop.params_from_jax({k: np.asarray(v) for k, v in jm._params.items()}, "cpu")
    cam = ds.camera
    ijs = torch.stack(torch.meshgrid(torch.arange(0, cam.height, 3), torch.arange(0, cam.width, 4),
                                     indexing="ij"), -1).reshape(-1, 2).float()[:256]
    u = torch.rand((ijs.shape[0], 32), generator=torch.Generator().manual_seed(0))
    c2w = torch.from_numpy(np.asarray(ds[len(ds) - 1]["c2w"], np.float32))
    out = []
    for params in (tm._params, jp):
        rgbd, _, _ = engine.render_block_tiled(
            tm._fset, cam, tm._rcfg, 32, tm._eval_near, tm._eval_far, params, tm._map_arrays.positions,
            tm._map_arrays.orientations, tm._allocated_mask(), ijs, c2w, u=u,
            sample_spacing=float(tm._sample_spacing),
        )
        out.append(to_np(rgbd))
    assert np.isfinite(out[0]).all()
    return float(np.abs(out[0] - out[1]).max())


def run_lockstep(cfg: dict, jds, ds, frames, spy: IterationSpy):
    """Both maps through ``frames``, held to each other after every frame
    -> per-frame gaps."""
    single_view = cfg.get("update_mode") == "single_view"
    jm = jengine.NeuralGraphMap(cfg)
    replay = JaxReplay(cfg)
    replay.camera = jds.camera
    tm = engine.NeuralGraphMap(cfg, "cpu", draws=replay)
    gaps, excluded = [], set()
    floor = chip_smoke.GradientFloor(optimizer)
    for fid in frames:
        want = jm.process_frame(jds, fid, jnp.asarray(jds[fid]["rgbd"]))
        start, n_before = len(spy.targets), tm.num_fields
        before = to_np(tm._map_arrays.positions)[:n_before].copy()
        with floor:
            got = tm.process_frame(ds, fid, ds[fid]["rgbd"])
        invalid_slots = 0
        for ids, valid in spy.targets[start:]:
            invalid_slots += int((~valid).sum())
            excluded |= set(ids[~valid].tolist()) & set(ids[valid].tolist())
        gap = _assert_same_frame(jm, tm, want, got, fid, single_view)
        gap["invalid_slots"], gap["excluded_fields"] = invalid_slots, sorted(excluded)
        gap["fields_moved"] = float(np.abs(to_np(tm._map_arrays.positions)[:n_before] - before).max(initial=0.0))
        gap["current_cached"] = bool(tm._cache_valid_np[0])
        gap["params"], gap["params_by_floor"] = _param_gaps(jm, tm, cfg["learning_rate"], excluded, floor)
        gaps.append(gap)
    return jm, tm, gaps


def _growth_case():
    cfg = tiny_config(num_iterations_per_frame=2)
    jds, ds = JaxSynthetic(SYNTH), SyntheticDataset(SYNTH)
    return cfg, jds, ds, range(12)


def _loop_closure_case(root: pathlib.Path):
    """A Replica-layout scene of the synthetic room at 64x48: PNG frames,
    SLAM estimates drifting along x up to 0.4 m until the loop closure at
    frame 8 snaps them to ground truth and drops keyframe 4; frame 5 has no
    pose (tracking lost: the current frame is not cached), and depths past
    ``max_depth`` 5 m are cut."""
    camera = {"w": 64, "h": 48, "fx": 56.0, "fy": 56.0, "cx": 31.5, "cy": 23.5, "scale": 6553.5}
    n, kf_freq, lc = 12, 2, LC_FRAME
    scene = root / "lc_room"
    (scene / "results").mkdir(parents=True)
    (root / "cam_params.json").write_text(json.dumps({"camera": camera}))
    synth = chip_smoke.replica_synthetic(camera, n)
    from neural_graph_mapping_tpu_torch.datasets.base import OGL2OCV

    np.savetxt(scene / "traj.txt", (synth.gt_c2ws @ OGL2OCV[None]).reshape(n, 16))
    chip_smoke.write_slam_files(scene, synth.gt_c2ws, kf_freq, lc, removed_kfs=(4,))
    c2w_file = scene / "orbslam2_c2w.json"
    estimates = json.loads(c2w_file.read_text())
    del estimates[str(LOST_FRAME)]["cur"]  # no estimate: a NaN pose
    c2w_file.write_text(json.dumps(estimates))
    chip_smoke.write_replica_frames(str(scene / "results"), camera, n, range(n))
    dcfg = dict(chip_smoke.REPLICA_DATASET["dataset_config"], root_dir=str(root), scene="lc_room")
    cfg = tiny_config(num_iterations_per_frame=2, max_depth=5.0)
    return cfg, JaxReplica(dcfg), ReplicaDataset(dcfg), range(n)


def _single_view_case():
    cfg = tiny_config(num_iterations_per_frame=2, update_mode="single_view")
    jds, ds = JaxSynthetic(SYNTH), SyntheticDataset(SYNTH)
    return cfg, jds, ds, range(3)


def _nrgbd_case(root: pathlib.Path):
    from neural_graph_mapping_tpu_torch.scripts import export_synthetic_nrgbd

    export_synthetic_nrgbd.export(root, SYNTH["num_frames"], SYNTH["width"], SYNTH["height"], SYNTH["fx"], workers=1)
    dcfg = tconfig.load_config("fps960.yaml")["dataset_config"]
    camera = dict(dcfg["camera"], width=SYNTH["width"], height=SYNTH["height"], fx=SYNTH["fx"], fy=SYNTH["fy"],
                  cx=SYNTH["width"] / 2, cy=SYNTH["height"] / 2)
    dcfg = dict(dcfg, root_dir=str(root), camera=camera)
    cfg = tiny_config(num_iterations_per_frame=2)
    return cfg, JaxNRGBD(dcfg), NRGBDDataset(dcfg), range(SYNTH["num_frames"])


def _full_width_case():
    """config/neural_graph_map.yaml + config/synthetic.yaml as they are
    (160x120, L = 16, T = 4096, 32 fields x 512 rays x (8 + 16) samples, 5
    iterations a frame), the first FULL_WIDTH_FRAMES frames."""
    cfg = tconfig.load_config("synthetic.yaml", tconfig.load_config("neural_graph_map.yaml"))
    dcfg = dict(cfg["dataset_config"], num_frames=FULL_WIDTH_FRAMES)
    return cfg, JaxSynthetic(dcfg), SyntheticDataset(dcfg), range(FULL_WIDTH_FRAMES)


@pytest.mark.slow
def test_full_width_run_in_lockstep_with_jax(tmp_path, monkeypatch):
    """The same lockstep at the production widths on the production scene,
    FULL_WIDTH_FRAMES frames (about ten minutes on 8 CPU cores; run by hand
    with ``-m slow -s``): the per-frame gaps are printed as one JSON line."""
    cfg, jds, ds, frames = _full_width_case()
    jds.load_slam_results()
    ds.load_slam_results()
    jm, tm, gaps = run_lockstep(cfg, jds, ds, frames, IterationSpy(monkeypatch))
    assert tm.num_fields >= cfg["num_train_fields"]
    print(json.dumps({"case": "full_width", "gaps": gaps}))


@pytest.mark.parametrize("case", ["growth", "loop_closure", "single_view", "nrgbd"])
def test_online_run_in_lockstep_with_jax(case, tmp_path, monkeypatch):
    if case == "growth":
        cfg, jds, ds, frames = _growth_case()
    elif case == "loop_closure":
        cfg, jds, ds, frames = _loop_closure_case(tmp_path)
    elif case == "nrgbd":
        cfg, jds, ds, frames = _nrgbd_case(tmp_path)
    else:
        cfg, jds, ds, frames = _single_view_case()
    jds.load_slam_results()
    ds.load_slam_results()
    spy = IterationSpy(monkeypatch)
    jm, tm, gaps = run_lockstep(cfg, jds, ds, frames, spy)
    assert sum(1 for g in gaps if g["params"]) and len(spy.targets) > 0
    assert _render_gap(tm, jm, ds) <= RENDER_ATOL
    if case == "growth":
        caps = [g["capacity"] for g in gaps]
        assert any(b > a for a, b in zip(caps, caps[1:])), caps  # grew after frames had trained
    if case == "loop_closure":
        assert 4 not in tm._kf_ids and 4 not in tm._kf2fields  # the dropped keyframe's fields moved on
        by_frame = {g["frame"]: g for g in gaps}
        assert by_frame[LC_FRAME]["fields_moved"] > 0.1  # re-anchored to the snapped poses
        assert all(g["fields_moved"] == 0.0 for f, g in by_frame.items() if f != LC_FRAME)
        assert not by_frame[LOST_FRAME]["current_cached"] and by_frame[LOST_FRAME + 1]["current_cached"]
    if case == "nrgbd":
        assert sorted(tm._kf_ids) == [0, 5, 10] and tm._frame_to_slot == {0: 1, 5: 2, 10: 3}
    print(json.dumps({"case": case, "gaps": gaps}))


def test_smoke_draw_source_replays_a_run_exactly():
    """chip_smoke's host draw source (its trajectory phase feeds the card's
    map and the CPU's the same draws through it): two maps of one seed on
    the CPU end bit for bit equal, a map without a source draws otherwise,
    and ``adam_state_gaps`` refuses a param moved past the tolerance."""
    from neural_graph_mapping_tpu_torch.mapping import map_state

    cfg = tiny_config(num_iterations_per_frame=2)
    ds = SyntheticDataset(SYNTH)
    ds.load_slam_results()
    frames = [ds[i]["rgbd"] for i in range(4)]
    floor = chip_smoke.GradientFloor(optimizer)
    runs = [chip_smoke.run_trajectory(torch, engine, map_state, cfg, ds, frames, "cpu", f) for f in (floor, None)]
    for a, b in zip(runs[0]["records"], runs[1]["records"]):
        assert a["losses"] == b["losses"] and a["fields"] == b["fields"] > 0
    want, got = (chip_smoke.map_adam_state(r["map"]) for r in runs)
    low = floor.low_steps({k: v.shape for k, v in want["params"].items()})
    gaps = chip_smoke.adam_state_gaps(want, got, cfg["learning_rate"], floor)
    assert all(g["param_all"] == 0.0 for g in gaps.values())
    assert 0.0 < gaps["w0"]["tight_share"] < 1.0
    plain = engine.NeuralGraphMap(cfg, "cpu")
    for fid, rgbd in enumerate(frames):
        plain.process_frame(ds, fid, rgbd)
    assert not torch.equal(plain._params["w0"], runs[0]["map"]._params["w0"])
    k = "w0"
    moved = (low[k] == 0) & (want["steps"] > 0)[:, None, None]
    got["params"][k] = got["params"][k] + np.where(moved, 2 * chip_smoke.LOCKSTEP_PARAM_ATOL, 0.0).astype(np.float32)
    with pytest.raises(AssertionError, match="params w0"):
        chip_smoke.adam_state_gaps(want, got, cfg["learning_rate"], floor)
