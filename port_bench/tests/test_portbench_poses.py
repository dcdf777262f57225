"""The harness's pose source and ``pose_gap``: every configuration's scene
is served ground truth through ``traffic.lap_dataset`` as before it; a scene
asking for a SLAM stream is refused; ``pose_gap`` reads the widest move or
turn between two maps' fields and runs through a cell's check."""

import math
import time

import numpy as np
import pytest
import torch

from port_bench import manifest as mf
from port_bench import run, scene, traffic
from port_bench.reference import check
from port_bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", [c["name"] for c in mf.load_manifest()["configs"]])
def test_a_scene_without_a_slam_block_keeps_its_ground_truth_traffic(name):
    sc = mf.load_config(name)["scene"]
    poses = scene.orbit(int(sc["lap_frames"]), float(sc["orbit_radius"]))
    got = traffic.lap_dataset(None, poses, 17, sc)
    want = traffic.LapDataset(None, poses, 17, sc["keyframe_every"])
    assert type(got) is traffic.LapDataset
    prev = None
    for f in list(range(60)) + list(range(955, 970)):
        assert np.array_equal(got.get_slam_c2ws(f), want.get_slam_c2ws(f)) and got.pose_index(f) == want.pose_index(f)
        assert got.is_keyframe(f) == want.is_keyframe(f) and not got.slam_poses_dirty(f)
        g = got.get_slam_essential_graph(f)
        assert g == want.get_slam_essential_graph(f)
        assert (g is prev) == (f % sc["keyframe_every"] != 0 and f not in (0, 955)), f
        prev = g


def test_a_scene_with_a_slam_block_is_refused():
    sc = dict(mf.load_config("ngm_multiview_640")["scene"], slam={})
    with pytest.raises(ValueError, match="slam"):
        traffic.lap_dataset(None, scene.orbit(40, 2.5), 0, sc)


def _maps(offset, angle, fields=5):
    g = torch.Generator().manual_seed(0)
    pos = torch.rand((8, 3), generator=g, dtype=torch.float64) * 3.0
    quat = torch.nn.functional.normalize(torch.rand((8, 4), generator=g, dtype=torch.float64), dim=-1)
    turn = torch.tensor([math.cos(angle / 2), 0.0, 0.0, math.sin(angle / 2)], dtype=torch.float64)  # w x y z
    w1, v1 = quat[:, :1], quat[:, 1:]
    w2, v2 = turn[:1], turn[1:]
    turned = torch.cat([w1 * w2 - (v1 * v2).sum(-1, keepdim=True),
                        w1 * v2 + w2 * v1 + torch.cross(v1, v2.expand_as(v1), dim=-1)], -1)
    moved = pos.clone()
    moved[2, 0] += offset
    return ({"positions": moved, "orientations": -turned, "fields": fields},
            {"positions": pos, "orientations": quat, "fields": fields})


def test_pose_gap_reads_the_widest_move_or_turn():
    assert check.pose_gap(*_maps(0.0, 0.0)) == pytest.approx(0.0, abs=1e-12)
    assert check.pose_gap(*_maps(3e-4, 0.0)) == pytest.approx(3e-4, rel=1e-4)
    assert check.pose_gap(*_maps(0.0, 2e-6)) == pytest.approx(2e-6, rel=1e-3)  # q and -q: one rotation
    prog, ref = _maps(0.0, 0.0)
    prog["positions"][1, 0] = float("nan")
    assert check.pose_gap(prog, ref) == float("inf")
    prog, ref = _maps(0.0, 0.0)
    prog["positions"][6] += 1.0  # beyond the fields in use
    assert check.pose_gap(prog, ref) == pytest.approx(0.0, abs=1e-12)


def test_a_tiny_cell_that_lists_pose_gap_reads_it_and_is_correct():
    cfg, wl = tiny_cell("mv_live")
    wl = dict(wl, check=dict(wl["check"], pose_gap=1e-6))
    res = run.run_cell("mv_live", cfg, wl, mf.load_manifest(), 2**31 + 23, 1.0, False, "cpu", time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["pose_gap"]["value"] == 0.0
