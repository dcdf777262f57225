"""The port's mesh evaluation and LPIPS against the JAX package's on the CPU:
accuracy / completion / F1, point-to-plane ICP, ICP alignment, bounds and
CO-SLAM culling and the whole raw-mesh evaluation equal JAX's to a relative
1e-6 on seeded meshes; LPIPS with synthetic weights within 1e-5, and it
raises without weights.

Also home of the on-disk NRGBD scenes the CLI tests share (the layouts of
tests/test_cli_e2e.py and tests/test_eval_e2e.py).
"""

import numpy as np
import pytest
import torch

from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
from neural_graph_mapping_tpu.eval import culling as jculling
from neural_graph_mapping_tpu.eval import mesh_metrics as jmesh_metrics
from neural_graph_mapping_tpu.eval import render_metrics as jrender_metrics
from neural_graph_mapping_tpu.utils import meshio as jmeshio
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.eval import culling, mesh_metrics, render_metrics
from neural_graph_mapping_tpu_torch.utils import meshio

EVAL_W, EVAL_H, EVAL_FRAMES = 80, 64, 8
CLI_W, CLI_H, CLI_FRAMES = 32, 24, 6


def write_eval_scene(root):
    """tests/test_eval_e2e.py's scene: a checkered wall at 1.8 m seen by 8
    frames and a quad ground-truth mesh of it -> the data root."""
    import PIL.Image

    scene = root / "data" / "tinyroom"
    (scene / "images").mkdir(parents=True)
    (scene / "depth_filtered").mkdir()
    yy, xx = np.mgrid[0:EVAL_H, 0:EVAL_W]
    for i in range(EVAL_FRAMES):
        checker = (((xx // 8) + (yy // 8) + i) % 2) * 180 + 40
        rgb = np.stack([checker, 255 - checker, np.full_like(checker, 90)], -1)
        PIL.Image.fromarray(rgb.astype(np.uint8)).save(scene / "images" / f"img{i}.png")
        depth = np.full((EVAL_H, EVAL_W), 1800, np.uint16)  # mm
        PIL.Image.fromarray(depth).save(scene / "depth_filtered" / f"depth{i}.png")
    poses = np.tile(np.eye(4, dtype=np.float64), (EVAL_FRAMES, 1, 1))
    poses[:, 0, 3] = 0.02 * np.arange(EVAL_FRAMES)
    np.savetxt(scene / "poses.txt", poses.reshape(-1, 4))
    g = np.linspace(-0.7, 0.7, 4)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([gx, gy, np.full_like(gx, -1.8)], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(3):
        for c in range(3):
            a, b = r * 4 + c, r * 4 + c + 1
            d, e = (r + 1) * 4 + c, (r + 1) * 4 + c + 1
            faces += [[a, b, e], [a, e, d]]
    meshio.save_ply(scene / "gt_mesh.ply", meshio.Mesh(verts, np.asarray(faces, np.int32)))
    return root / "data"


def write_cli_scene(root):
    """tests/test_cli_e2e.py's scene: 6 noise frames at 1.8-2.0 m and an
    empty ground-truth file -> the data root."""
    import PIL.Image

    scene = root / "data" / "tinyroom"
    (scene / "images").mkdir(parents=True)
    (scene / "depth_filtered").mkdir()
    rng = np.random.default_rng(0)
    for i in range(CLI_FRAMES):
        rgb = rng.integers(0, 255, (CLI_H, CLI_W, 3), dtype=np.uint8)
        PIL.Image.fromarray(rgb).save(scene / "images" / f"img{i}.png")
        depth = np.full((CLI_H, CLI_W), 1800 + 40 * i, np.uint16)  # mm
        PIL.Image.fromarray(depth).save(scene / "depth_filtered" / f"depth{i}.png")
    poses = np.tile(np.eye(4, dtype=np.float64), (CLI_FRAMES, 1, 1))
    poses[:, 0, 3] = 0.05 * np.arange(CLI_FRAMES)
    np.savetxt(scene / "poses.txt", poses.reshape(-1, 4))
    (scene / "gt_mesh.ply").write_bytes(b"")
    return root / "data"


def eval_dataset_config(data_root):
    return {
        "root_dir": str(data_root), "scene": "tinyroom",
        "camera": {"width": EVAL_W, "height": EVAL_H, "fx": 70.0, "fy": 70.0,
                   "cx": EVAL_W / 2 - 0.5, "cy": EVAL_H / 2 - 0.5},
        "pose_source": "gt", "pg_source": "fixed_kf_freq", "fixed_kf_freq": 2,
    }


def write_lpips_weights(path):
    """Synthetic AlexNet-LPIPS weights in the export_lpips.py schema."""
    rng = np.random.default_rng(7)
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3), (256, 256, 3, 3)]
    arrays = {}
    for i, s in enumerate(shapes):
        arrays[f"conv{i}_w"] = rng.standard_normal(s).astype(np.float32) * 0.05
        arrays[f"conv{i}_b"] = rng.standard_normal(s[0]).astype(np.float32) * 0.01
        arrays[f"lin{i}_w"] = np.abs(rng.standard_normal((1, s[0], 1, 1)).astype(np.float32))
    np.savez(path, **arrays)
    return path


def _pair(mesh):
    return meshio.Mesh(mesh.vertices, mesh.faces), jmeshio.Mesh(mesh.vertices, mesh.faces)


def wall_meshes(seed=0):
    """(est, gt) around the eval scene's wall: the ground truth subdivided,
    the estimate shifted 1 cm, noisy, with a stray patch behind the wall."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-0.8, 0.8, 9)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([gx, gy, np.full_like(gx, -1.8)], -1).reshape(-1, 3)
    faces = []
    for r in range(8):
        for c in range(8):
            a, b, d, e = r * 9 + c, r * 9 + c + 1, (r + 1) * 9 + c, (r + 1) * 9 + c + 1
            faces += [[a, b, e], [a, e, d]]
    faces = np.asarray(faces, np.int32)
    gt = meshio.Mesh(verts.astype(np.float32), faces)
    est_v = verts + np.array([0.01, -0.005, 0.01]) + rng.normal(0, 0.003, verts.shape)
    stray = np.array([[0.0, 0.0, -3.0], [0.3, 0.0, -3.0], [0.0, 0.3, -3.0]])
    est = meshio.Mesh(
        np.concatenate([est_v, stray]).astype(np.float32),
        np.concatenate([faces, [[81, 82, 83]]]).astype(np.int32),
    )
    return est, gt


def assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)


def test_accuracy_completion_metrics_equal_jax():
    rng = np.random.default_rng(1)
    est = rng.normal(size=(3000, 3)).astype(np.float32)
    gt = (est[:2500] + rng.normal(0, 0.02, (2500, 3))).astype(np.float32)
    assert_metrics_close(
        mesh_metrics.accuracy_completion_metrics(est, gt), jmesh_metrics.accuracy_completion_metrics(est, gt)
    )


def test_icp_point_to_plane_equals_jax():
    est, gt = wall_meshes(1)
    src, _ = est.sample_surface(4000, 0)
    dst, fidx = gt.sample_surface(4000, 1)
    normals = gt.face_normals()[fidx]
    want = jmesh_metrics.icp_point_to_plane(src, dst, normals)
    got = mesh_metrics.icp_point_to_plane(src, dst, normals)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert not np.allclose(got, np.eye(4))


def test_align_mesh_and_evaluate_meshes_equal_jax():
    est, gt = wall_meshes(2)
    (pe, je), (pg, jg) = _pair(est), _pair(gt)
    np.testing.assert_allclose(
        mesh_metrics.align_mesh(pe, pg, num_points=5000).vertices,
        jmesh_metrics.align_mesh(je, jg, num_points=5000).vertices, rtol=1e-6, atol=1e-7,
    )
    for align in (False, True):
        assert_metrics_close(
            mesh_metrics.evaluate_meshes(pe, pg, num_points=5000, align=align),
            jmesh_metrics.evaluate_meshes(je, jg, num_points=5000, align=align),
        )


def test_cull_by_bounds_equals_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    bounds = np.array([[-1.0, -0.5, -1.5], [1.2, 0.7, 1.0]], np.float32)
    np.testing.assert_array_equal(culling.cull_by_bounds(pts, bounds), jculling.cull_by_bounds(pts, bounds))


@pytest.fixture(scope="module")
def eval_scene(tmp_path_factory):
    root = write_eval_scene(tmp_path_factory.mktemp("eval_scene"))
    cfg = eval_dataset_config(root)
    ds, jds = NRGBDDataset(cfg), JaxNRGBD(cfg)
    ds.load_slam_results()
    jds.load_slam_results()
    return ds, jds


@pytest.mark.parametrize("method", ["virt_cams", "occlusion", "frustum"])
def test_cull_mesh_equals_jax(eval_scene, method):
    ds, jds = eval_scene
    est, _ = wall_meshes(4)
    got = culling.cull_mesh(_pair(est)[0], ds, method)
    want = jculling.cull_mesh(_pair(est)[1], jds, method)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert 0 < len(got.faces) < len(est.subdivide_to_size(0.1).faces)


def test_evaluate_raw_mesh_equals_jax(eval_scene):
    ds, jds = eval_scene
    est, _ = wall_meshes(5)
    pe, je = _pair(est)
    got = culling.evaluate_raw_mesh(pe, ds, "virt_cams", align=True, num_points=3000)
    want = jculling.evaluate_raw_mesh(je, jds, "virt_cams", align=True, num_points=3000)
    assert "accuracy" in got and "f1_5cm" in got
    assert_metrics_close(got, want)


def test_nrgbd_dataset_equals_jax(eval_scene):
    ds, jds = eval_scene
    assert len(ds) == len(jds) and ds.has_gt_mesh and jds.has_gt_mesh
    for fid in (0, 5):
        np.testing.assert_array_equal(ds[fid]["rgbd"], jds[fid]["rgbd"])
        np.testing.assert_array_equal(ds.get_slam_c2ws(fid), np.asarray(jds.get_slam_c2ws(fid)))
    np.testing.assert_array_equal(ds.load_gt_mesh().faces, jds.load_gt_mesh().faces)
    np.testing.assert_allclose(ds.scene_bounds, jds.scene_bounds, rtol=1e-6)


@pytest.fixture
def lpips_weights(tmp_path, monkeypatch):
    path = write_lpips_weights(tmp_path / "lpips_fixture.npz")
    monkeypatch.setenv("NGM_LPIPS_WEIGHTS", str(path))
    render_metrics._lpips_weights.cache_clear()
    jrender_metrics._lpips_weights.cache_clear()
    yield path
    render_metrics._lpips_weights.cache_clear()
    jrender_metrics._lpips_weights.cache_clear()


@pytest.mark.parametrize("crop", [None, 4])
def test_lpips_equals_jax(lpips_weights, crop):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (EVAL_H, EVAL_W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), -0.2, 1.2).astype(np.float32)
    want = jrender_metrics.lpips(jnp.asarray(a), jnp.asarray(b), crop)
    got = render_metrics.lpips(torch.from_numpy(a), torch.from_numpy(b), crop)
    assert want > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert render_metrics.lpips(torch.from_numpy(a), torch.from_numpy(a), crop) == 0.0


def test_lpips_raises_without_weights(monkeypatch):
    monkeypatch.delenv("NGM_LPIPS_WEIGHTS", raising=False)
    render_metrics._lpips_weights.cache_clear()
    img = torch.zeros((EVAL_H, EVAL_W, 3))
    with pytest.raises(FileNotFoundError):
        render_metrics.lpips(img, img)
    render_metrics._lpips_weights.cache_clear()
