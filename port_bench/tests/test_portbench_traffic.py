"""The traffic: the same seed gives the same inputs; the scene is the
repository's synthetic room."""

import copy

import numpy as np
import torch

from port_bench import manifest as mf
from port_bench import scene, traffic
from port_bench.reference.ngm.mapping.engine import DrawShapes

BIG_SEED = 2**33 + 7
SHAPES = DrawShapes(capacity=64, num_train_fields=4, num_rays=8, num_slots=10, num_coarse=8, num_guided=16,
                    height=6, width=8)


def _map_config():
    return mf.load_config("ngm_multiview_640")["map"]


def _draws(seed):
    src = traffic.SeededDraws(seed, _map_config(), "cpu")
    depth = torch.rand(10, 6, 8)
    depth[:, :2] = 0.0
    valid = torch.tensor([True, True, True] + [False] * 7)
    return [src.init_fields(3), src.allocation_shift(1), src.observed_gumbel(1, SHAPES, 5),
            src.multi_view(2, 2, SHAPES), src.single_view(2, SHAPES, depth, valid)]


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


def test_the_same_seed_gives_the_same_draws_and_another_seed_others():
    a, b, c = (_flat(_draws(s)) for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    assert len(a) == len(b) == len(c) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c) if x.is_floating_point())


def test_single_view_cloud_lies_on_valid_pixels_of_the_view_the_map_trains():
    src = traffic.SeededDraws(5, _map_config(), "cpu")
    depth = torch.zeros(10, 6, 8)
    depth[0, 3:] = 1.0  # the current frame: rows 3.. valid
    depth[1, :, :4] = 2.0  # keyframe slot 1: left half valid
    valid = torch.tensor([True, True] + [False] * 8)
    for i, d in enumerate(src.single_view(4, SHAPES, depth, valid)):
        slot = 0 if i % 2 else 1
        assert bool((depth[slot].reshape(-1)[d.cloud_idx] != 0).all())


def test_lap_dataset_keyframes_graph_and_wrap():
    poses = scene.orbit(20, 2.5)
    ds = traffic.LapDataset(None, poses, phase=7, keyframe_every=5)
    assert np.array_equal(ds.get_slam_c2ws(13), poses[0]) and np.array_equal(ds.get_slam_c2ws(33), poses[0])
    assert [f for f in range(12) if ds.is_keyframe(f)] == [0, 5, 10]
    g6, g9 = ds.get_slam_essential_graph(6), ds.get_slam_essential_graph(9)
    assert g6 is g9 and g6 == {0: {0, 5}, 5: {0, 5}}
    assert ds.get_slam_essential_graph(10) == {k: {0, 5, 10} for k in (0, 5, 10)}
    assert not ds.slam_poses_dirty(3)


def test_scene_is_the_synthetic_dataset_quantised():
    from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
    from neural_graph_mapping_tpu_torch.scripts.export_synthetic_nrgbd import quantise

    sc = dict(copy.deepcopy(mf.load_config("ngm_multiview_640")["scene"]), width=40, height=30, fx=35.0, fy=35.0,
              lap_frames=12)
    ds = SyntheticDataset({"num_frames": 12, "width": 40, "height": 30, "fx": 35.0, "fy": 35.0})
    frames, poses = scene.cast_lap(sc, "cpu", [0, 5])
    np.testing.assert_allclose(poses, ds.gt_c2ws, atol=1e-6)
    for i in (0, 5):
        rgb8, depth_mm = quantise(ds._raycast(ds.gt_c2ws[i]))
        assert np.abs(frames[i][..., :3] * 255.0 - rgb8).max() <= 1.0 + 1e-3
        assert np.abs(frames[i][..., 3] * 1000.0 - depth_mm).max() <= 1.0 + 1e-3
        assert np.mean(np.abs(frames[i][..., :3] * 255.0 - rgb8) > 0.5) < 0.01
