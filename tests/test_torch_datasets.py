"""The port's Replica, ScanNet and Kintinuous loaders (and NRGBD's, which now
reads through ``utils/imageio``) against the JAX package's.

The on-disk layouts are those ``tests/test_dataset_loaders.py`` writes,
built here by this file's own copy of its writers, plus the ORB-SLAM2
result files on every layout. Each package reads its own copy of a scene
(each caches parsed SLAM results and scene bounds beside the files). Held
to JAX: the camera, ``num_images``, every frame's ``rgbd`` and ``c2w``
exactly, the SLAM poses, pose graph and keyframes, the final trajectory,
and the scene bounds. Then the port's CLI runs on the Replica layout
through ``config/neural_graph_map.yaml`` + ``config/replica_imap_dataset.yaml``
beside JAX's CLI on the same scene.
"""

import dataclasses
import json
import pathlib

import numpy as np
import PIL.Image
import pytest
import yaml
from scipy.spatial.transform import Rotation

from neural_graph_mapping_tpu import run_mapping as jrun
from neural_graph_mapping_tpu.datasets.kintinuous import KintinuousDataset as JaxKintinuous
from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
from neural_graph_mapping_tpu.datasets.replica import ReplicaDataset as JaxReplica
from neural_graph_mapping_tpu.datasets.scannet import ScanNetDataset as JaxScanNet
from neural_graph_mapping_tpu_torch import run_mapping
from neural_graph_mapping_tpu_torch.datasets.base import OGL2OCV
from neural_graph_mapping_tpu_torch.datasets.kintinuous import KintinuousDataset
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.datasets.replica import ReplicaDataset
from neural_graph_mapping_tpu_torch.datasets.scannet import ScanNetDataset

W, H = 16, 12
N_FRAMES = 4
CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / "config"

# -- the fixtures' writers (a copy of tests/test_dataset_loaders.py's) ---------


def write_rgb(path, value=128):
    arr = np.full((H, W, 3), value, np.uint8)
    arr[0, 0] = [255, 0, 0]  # corner marker
    PIL.Image.fromarray(arr).save(path)


def write_depth_mm(path, mm=1500):
    PIL.Image.fromarray(np.full((H, W), mm, np.uint16)).save(path)


def gt_poses(n=N_FRAMES):
    """Simple translating trajectory, OpenGL c2w."""
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, 0, 3] = 0.1 * np.arange(n)
    return poses


def pose_vec(c2w_gl):
    """OpenGL c2w 4x4 -> ORB-SLAM2 export vector [x y z qx qy qz qw]."""
    m = np.asarray(c2w_gl, np.float64) @ OGL2OCV.astype(np.float64)
    q = Rotation.from_matrix(m[:3, :3]).as_quat()  # xyzw
    return [*m[:3, 3].tolist(), *q.tolist()]


def write_slam_files(scene_dir, poses, kf_freq=2):
    """ORB-SLAM2-style c2w history JSON, pose-graph JSON, final-traj txt."""
    c2w_data, pg_data, kf_ids = {}, {}, []
    for at in range(len(poses)):
        entry = {"cur": pose_vec(poses[at])}
        for kf in kf_ids:
            entry[str(kf)] = pose_vec(poses[kf])
        c2w_data[str(at)] = entry
        if at % kf_freq == 0:
            kf_ids.append(at)
            pg_data[str(at)] = [
                {"KF": kf, "LC": [], "CV": [o for o in kf_ids if o != kf], "WGT": [100] * (len(kf_ids) - 1)}
                for kf in kf_ids
            ]
    (scene_dir / "orbslam2_c2w.json").write_text(json.dumps(c2w_data))
    (scene_dir / "orbslam2_pg.json").write_text(json.dumps(pg_data))
    rows = [" ".join(str(v) for v in [i, *pose_vec(poses[i])]) for i in range(len(poses))]
    (scene_dir / "orbslam2_final.txt").write_text("\n".join(rows))


SLAM_CONFIG = dict(
    slam_c2w_file="orbslam2_c2w.json",
    slam_pg_file="orbslam2_pg.json",
    slam_final_file="orbslam2_final.txt",
)
CAMERA = dict(width=W, height=H, fx=10.0, fy=10.0, cx=8.0, cy=6.0)


def write_nrgbd(root):
    scene = root / "whiteroom"
    (scene / "images").mkdir(parents=True)
    (scene / "depth_filtered").mkdir()
    for i in range(N_FRAMES):
        write_rgb(scene / "images" / f"img{i}.png", 100 + 20 * i)
        write_depth_mm(scene / "depth_filtered" / f"depth{i}.png", 1500 + 100 * i)
    poses = gt_poses()
    np.savetxt(scene / "poses.txt", poses.reshape(-1, 4))
    (scene / "gt_mesh.ply").write_bytes(b"")
    write_slam_files(scene, poses)
    return dict(root_dir=str(root), scene="whiteroom", camera=CAMERA, **SLAM_CONFIG)


def write_replica(root, ext="jpg"):
    scene = root / "office0"
    (scene / "results").mkdir(parents=True)
    cam = dict(w=W, h=H, fx=10.0, fy=10.0, cx=8.0, cy=6.0, scale=6553.5)
    (root / "cam_params.json").write_text(json.dumps({"camera": cam}))
    for i in range(N_FRAMES):
        write_rgb(scene / "results" / f"frame{i:06d}.{ext}", 90 + 30 * i)
        write_depth_mm(scene / "results" / f"depth{i:06d}.png", mm=6554 + 1000 * i)
    poses = gt_poses()
    np.savetxt(scene / "traj.txt", (poses @ OGL2OCV.astype(np.float64)).reshape(N_FRAMES, 16))
    (root / "office0_mesh.ply").write_bytes(b"")
    write_slam_files(scene, poses)
    return dict(root_dir=str(root), scene="office0", **SLAM_CONFIG)


def write_scannet(root):
    scene = root / "scene0000_00"
    for sub in ("color", "depth", "pose", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    for i in range(N_FRAMES):
        # colour at twice the depth resolution: the Lanczos align cache
        arr = np.full((2 * H, 2 * W, 3), 100 + 10 * i, np.uint8)
        arr[: H // 2] = 30
        PIL.Image.fromarray(arr).save(scene / "color" / f"{i}.jpg")
        write_depth_mm(scene / "depth" / f"{i}.png", mm=2000 + 50 * i)
    poses = gt_poses()
    poses_ocv = poses @ OGL2OCV.astype(np.float64)
    for i in range(N_FRAMES):
        np.savetxt(scene / "pose" / f"{i}.txt", poses_ocv[i])
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 10.0
    intr[0, 2], intr[1, 2] = 8.0, 6.0
    np.savetxt(scene / "intrinsic" / "intrinsic_depth.txt", intr)
    write_slam_files(scene, poses)
    return dict(root_dir=str(root), scene="scene0000_00", **SLAM_CONFIG)


def write_kintinuous(root):
    scene = root / "loop"
    (scene / "color").mkdir(parents=True)
    (scene / "depth").mkdir()
    for i in range(N_FRAMES):
        write_rgb(scene / "color" / f"{i * 33333}.png", 60 + 40 * i)
        write_depth_mm(scene / "depth" / f"{i * 33333}.png", mm=1000 + 10 * i)
    write_slam_files(scene, gt_poses())
    return dict(root_dir=str(root), scene="loop", camera=CAMERA, **SLAM_CONFIG)


LAYOUTS = {
    "nrgbd": (write_nrgbd, NRGBDDataset, JaxNRGBD),
    "replica": (write_replica, ReplicaDataset, JaxReplica),
    "scannet": (write_scannet, ScanNetDataset, JaxScanNet),
    "kintinuous": (write_kintinuous, KintinuousDataset, JaxKintinuous),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loader_equals_jax(tmp_path, layout):
    write, cls, jcls = LAYOUTS[layout]
    cfg = write(tmp_path / "port")
    jcfg = write(tmp_path / "jax")
    ds, jds = cls(cfg), jcls(jcfg)
    assert cls.get_available_scenes(cfg["root_dir"]) == jcls.get_available_scenes(jcfg["root_dir"])
    assert dataclasses.asdict(ds.camera) == dataclasses.asdict(jds.camera)
    assert ds.num_images == jds.num_images == N_FRAMES == len(ds)
    np.testing.assert_array_equal(ds.gt_c2ws, jds.gt_c2ws)
    for i in range(N_FRAMES):
        got, want = ds[i], jds[i]
        assert got["rgbd"].dtype == want["rgbd"].dtype == np.float32
        np.testing.assert_array_equal(got["rgbd"], want["rgbd"])
        np.testing.assert_array_equal(got["c2w"], want["c2w"])
        assert got["time"] == want["time"]
    assert ds.has_gt_mesh == jds.has_gt_mesh
    ds.load_slam_results()
    jds.load_slam_results()
    for at in range(N_FRAMES):
        assert ds.get_slam_essential_graph(at) == jds.get_slam_essential_graph(at)
        for fid in range(N_FRAMES):
            assert ds.is_keyframe(fid, at) == jds.is_keyframe(fid, at)
            np.testing.assert_array_equal(ds.get_slam_c2ws(fid, at), np.asarray(jds.get_slam_c2ws(fid, at)))
    np.testing.assert_array_equal(ds.slam_final_c2ws, jds.slam_final_c2ws)
    np.testing.assert_array_equal(ds.slam_online_c2ws, jds.slam_online_c2ws)
    custom = getattr(ds, "custom_scene_bounds", None)
    want_custom = getattr(jds, "custom_scene_bounds", None)
    assert (custom is None) == (want_custom is None)
    if custom is not None:
        np.testing.assert_array_equal(custom, want_custom)
    bounds, want_bounds = ds.scene_bounds, jds.scene_bounds
    if want_bounds is None:
        assert bounds is None
    else:
        # the back-projection's float32 products, each package's own
        np.testing.assert_allclose(bounds, want_bounds, atol=1e-5)


def test_scannet_aligns_colour_as_jax(tmp_path):
    """The Lanczos-resized colour cache the port writes equals JAX's byte for
    byte, and a missing pose file gives a NaN pose in both."""
    for name in ("port", "jax"):
        write_scannet(tmp_path / name)
        (tmp_path / name / "scene0000_00" / "pose" / "2.txt").unlink()
    ds = ScanNetDataset(dict(root_dir=str(tmp_path / "port"), scene="scene0000_00"))
    jds = JaxScanNet(dict(root_dir=str(tmp_path / "jax"), scene="scene0000_00"))
    np.testing.assert_array_equal(ds.gt_c2ws, jds.gt_c2ws)
    for name in ("0.jpg", "3.jpg"):
        got = (tmp_path / "port" / "scene0000_00" / "aligned_color_to_depth" / name).read_bytes()
        assert got == (tmp_path / "jax" / "scene0000_00" / "aligned_color_to_depth" / name).read_bytes()
    assert np.isnan(ds.gt_c2ws[2]).all() and np.isfinite(ds.gt_c2ws[1]).all()
    assert (ds.camera.width, ds.camera.height, ds.camera.cx) == (W, H, 7.5)


def test_replica_png_frames_read_without_change(tmp_path):
    """Replica's loader takes any ``frame*`` file: PNG colour frames (what
    a machine without PIL can read) give JAX's values."""
    cfg = write_replica(tmp_path / "port", ext="png")
    jcfg = write_replica(tmp_path / "jax", ext="png")
    ds, jds = ReplicaDataset(cfg), JaxReplica(jcfg)
    for i in range(N_FRAMES):
        np.testing.assert_array_equal(ds[i]["rgbd"], jds[i]["rgbd"])
    np.testing.assert_allclose(ds[1]["rgbd"][..., 3], 7554 / 6553.5, rtol=1e-6)


def test_cli_on_replica_layout_matches_jax(tmp_path):
    """Both CLIs through config/neural_graph_map.yaml +
    config/replica_imap_dataset.yaml, root_dir and scene overridden, the run
    cut to the fixture's 4 frames and one small iteration a frame: the
    checkpoint's keys and shapes and the metric keys equal JAX's."""
    for name in ("port", "jax"):
        write_replica(tmp_path / name / "data")
    common = [
        "--dataset_config.scene", "office0", "--num_iterations_per_frame", "1",
        "--num_train_fields", "4", "--num_rays_per_field", "32", "--num_kf_slots", "16",
        "--max_new_fields", "16", "--extract_mesh", "false", "--disable_eval", "true",
    ]
    configs = [str(CONFIG_DIR / "neural_graph_map.yaml"), str(CONFIG_DIR / "replica_imap_dataset.yaml")]
    jrun.main(["--config", *configs, "--dataset_config.root_dir", str(tmp_path / "jax" / "data"),
               "--out_dir", str(tmp_path / "jax" / "runs"), *common])
    run_mapping.main(["--config", *configs, "--dataset_config.root_dir", str(tmp_path / "port" / "data"),
                      "--out_dir", str(tmp_path / "port" / "runs"), "--device", "cpu", *common])
    runs = {}
    for name in ("port", "jax"):
        (run,) = list((tmp_path / name / "runs").iterdir())
        (ckpt,) = list(run.glob("*.npz"))
        with np.load(ckpt) as data:
            shapes = {k: data[k].shape for k in data.files}
        results = yaml.safe_load((run / "latest_run.yaml").read_text())["results"]
        runs[name] = shapes, results
    assert runs["port"][0] == runs["jax"][0]
    got, want = runs["port"][1], runs["jax"][1]
    assert set(got) == set(want)
    assert got["num_params_per_field"] == want["num_params_per_field"]
    assert got["num_fields"] > 0
    assert all(np.isfinite(v) for v in got.values())


def test_chip_smoke_replica_config_equals_yaml(monkeypatch, tmp_path):
    """chip_smoke.py writes config/neural_graph_map.yaml,
    config/replica_imap_dataset.yaml and config/coslam_eval.yaml out (the
    card's machine may lack PyYAML); merged, they must equal what the loader
    gives for the three files, and its replica phase's run config is that
    merge with the scene's root and its overrides."""
    import chip_smoke

    from neural_graph_mapping_tpu_torch import config as tconfig

    monkeypatch.delenv("NGM_DATA_DIR", raising=False)
    want = tconfig.load_config("neural_graph_map.yaml")
    assert chip_smoke.MODEL_CONFIG == want
    want = tconfig.load_config("coslam_eval.yaml", tconfig.load_config("replica_imap_dataset.yaml", want))
    got = tconfig._deep_merge(tconfig._deep_merge(chip_smoke.MODEL_CONFIG, chip_smoke.REPLICA_DATASET),
                              chip_smoke.COSLAM_EVAL)
    assert got == want
    run = chip_smoke.replica_config(tmp_path, tmp_path / "runs")
    assert run["dataset_config"]["root_dir"] == str(tmp_path)
    assert run["dataset_config"]["scene"] == chip_smoke.REPLICA_SCENE
    assert {k: v for k, v in run.items() if k != "dataset_config"} == dict(
        {k: v for k, v in want.items() if k != "dataset_config"}, eval_ratio=chip_smoke.REPLICA_EVAL_RATIO,
        eval_metrics=["psnr", "depthl1"], extract_mesh=True, mesh_resolution=0.04, eval_store_details=False,
        render_vis=False, out_dir=str(tmp_path / "runs"))


def test_chip_smoke_replica_scene_reads_in_both_packages(tmp_path, monkeypatch):
    """The smoke's Replica-layout writer at a small camera and frame count
    (the frames written in this process): JAX's loader and the port's read
    the same frames and SLAM results, and the scene's mesh is the analytic
    spheres and room walls."""
    import chip_smoke

    from neural_graph_mapping_tpu_torch.utils import meshio

    cam = {"w": 40, "h": 24, "fx": 20.0, "fy": 20.0, "cx": 19.5, "cy": 11.5, "scale": 6553.5}
    monkeypatch.setattr(chip_smoke, "REPLICA_CAMERA", cam)
    monkeypatch.setattr(chip_smoke, "REPLICA_FRAMES", 20)
    monkeypatch.setattr(chip_smoke, "REPLICA_LC_FRAME", 15)
    root = tmp_path / "replica"
    chip_smoke.write_replica_scene(root, workers=1)
    cfg = dict(root_dir=str(root), scene=chip_smoke.REPLICA_SCENE, **SLAM_CONFIG)
    ds, jds = ReplicaDataset(cfg), JaxReplica(cfg)
    assert (ds.camera.width, ds.camera.height, ds.camera.cx) == (40, 24, 20.0)
    assert ds.custom_scene_bounds is None and ds.has_gt_mesh
    synth = chip_smoke.replica_synthetic(cam, 20)
    for i in (0, 7, 19):
        np.testing.assert_array_equal(ds[i]["rgbd"], jds[i]["rgbd"])
        np.testing.assert_array_equal(ds[i]["c2w"], synth.gt_c2ws[i])
        want = synth._raycast(synth.gt_c2ws[i])
        np.testing.assert_allclose(ds[i]["rgbd"][..., :3], want[..., :3], atol=0.5 / 255 + 1e-6)
        np.testing.assert_allclose(ds[i]["rgbd"][..., 3], want[..., 3], atol=0.5 / 6553.5 + 1e-6)
    ds.load_slam_results()
    jds.load_slam_results()
    for at in (14, 15, 19):
        assert ds.get_slam_essential_graph(at) == jds.get_slam_essential_graph(at)
    # drift before the loop closure, ground truth from it on; keyframe 10 removed
    assert not np.allclose(ds.get_slam_c2ws(5, 14), synth.gt_c2ws[5], atol=1e-3)
    np.testing.assert_allclose(ds.get_slam_c2ws(5, 15), synth.gt_c2ws[5], atol=1e-5)
    assert 10 not in ds.get_slam_essential_graph(19) and 0 in ds.get_slam_essential_graph(19)[15]
    mesh = meshio.load_ply(root / f"{chip_smoke.REPLICA_SCENE}_mesh.ply")
    r = np.linalg.norm(mesh.vertices[:, None, :] - synth._sphere_c[None], axis=-1) - synth._sphere_r[None]
    on_wall = np.isclose(np.abs(mesh.vertices).max(-1), synth._room_half, atol=1e-5)
    assert (np.isclose(r, 0.0, atol=1e-5).any(-1) | on_wall).all()


def test_chip_smoke_replica_scene_scores_its_own_mesh(tmp_path, monkeypatch):
    """The mesh-eval protocol the smoke's replica phase runs (virt_cams
    culling, ICP alignment, 200,000 points), on the smoke's scene at a small
    camera, scoring the scene's ground-truth mesh jittered by 5 mm: the
    scene, its poses and its mesh agree (completion under 2 cm, F1 at 5 cm
    above 0.95)."""
    import chip_smoke

    from neural_graph_mapping_tpu_torch.eval import culling
    from neural_graph_mapping_tpu_torch.utils import meshio

    cam = {"w": 120, "h": 68, "fx": 60.0, "fy": 60.0, "cx": 59.5, "cy": 33.5, "scale": 6553.5}
    monkeypatch.setattr(chip_smoke, "REPLICA_CAMERA", cam)
    monkeypatch.setattr(chip_smoke, "REPLICA_FRAMES", 20)
    monkeypatch.setattr(chip_smoke, "REPLICA_LC_FRAME", 15)
    root = tmp_path / "replica"
    chip_smoke.write_replica_scene(root, workers=1)
    ds = ReplicaDataset(dict(root_dir=str(root), scene=chip_smoke.REPLICA_SCENE))
    gt = ds.load_gt_mesh()
    rng = np.random.default_rng(0)
    est = meshio.Mesh(gt.vertices + rng.normal(0, 0.005, gt.vertices.shape).astype(np.float32), gt.faces)
    metrics = culling.evaluate_raw_mesh(est, ds, "virt_cams", align=True, num_points=200000)
    assert metrics["completion"] < 0.02 and metrics["accuracy"] < 0.02
    assert metrics["f1_5cm"] > 0.95
