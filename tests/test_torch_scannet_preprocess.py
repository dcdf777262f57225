"""ScanNet's colour preprocessing without PIL, against PIL and the JAX
package: ``imageio.resize_lanczos`` against ``Image.resize(size,
Resampling.LANCZOS)``, the port's JPEG encoder against ``Image.save`` at
PIL's defaults (the same file bytes, and the same pixels through the port's
decoder), and a ScanNet scene's first run with PIL blocked from import
against the JAX package's first run with PIL."""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from test_torch_datasets import OGL2OCV, SLAM_CONFIG, gt_poses, write_slam_files
from test_torch_no_jax import _BLOCKER, ROOT

from neural_graph_mapping_tpu.datasets.scannet import ScanNetDataset as JaxScanNet
from neural_graph_mapping_tpu_torch.utils import imageio, jpeg


def _smooth(shape, seed):
    """A natural-looking 8-bit image: smooth waves plus noise."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    c = shape[2] if len(shape) == 3 else 1
    a = np.stack([128 + 100 * np.sin(x / (5.0 + k) + k) * np.cos(y / 9.0 - k) for k in range(c)], -1)
    a = np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8)
    return a if len(shape) == 3 else a[..., 0]


def _pil_resize(a, size):
    return np.asarray(PIL.Image.fromarray(a).resize(size, resample=PIL.Image.Resampling.LANCZOS))


@pytest.mark.parametrize(
    "shape,size",
    [((968, 1296, 3), (640, 480)), ((48, 64, 3), (131, 97)), ((61, 47, 3), (23, 59)), ((33, 45), (17, 29)),
     ((10, 10, 3), (10, 7)), ((7, 5, 3), (7, 5))],
    ids=["scannet-1296x968-to-640x480", "upscale", "odd-down-up", "gray-odd", "vertical-only", "same-size"],
)
def test_resize_lanczos_equals_pil(shape, size):
    """Byte for byte, on a smooth image and on uniform noise (the noise
    drives the sums to both ends of clip8)."""
    for a in (_smooth(shape, 0), np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)):
        got = imageio.resize_lanczos(a, size)
        want = _pil_resize(a, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_resize_lanczos_rejects_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        imageio.resize_lanczos(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        imageio.resize_lanczos(np.zeros((4, 4), np.uint8), (0, 2))


def _pil_jpeg(a):
    buf = io.BytesIO()
    PIL.Image.fromarray(a).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize(
    "shape",
    [(480, 640, 3), (48, 64, 3), (37, 53, 3), (17, 9, 3), (9, 17, 3), (1, 1, 3), (61, 47), (30, 40)],
    ids=["640x480", "64x48", "odd-53x37", "9x17", "17x9", "1x1", "gray-47x61", "gray-40x30"],
)
def test_encoder_writes_pils_file(shape):
    """At PIL's defaults (quality 75, 4:2:0, standard Huffman tables) the
    port's file is PIL's file byte for byte, so the port's decoder reads
    both to the same pixels; and those pixels are PIL's reading of PIL's
    file. Odd sizes exercise the edge replication and the dummy blocks."""
    for a in (_smooth(shape, 2), np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)):
        mine, pils = jpeg.encode(a), _pil_jpeg(a)
        got = jpeg.decode(mine)
        np.testing.assert_array_equal(got, jpeg.decode(pils))
        np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(io.BytesIO(pils))))
        assert mine == pils


def test_write_jpeg_and_encoder_errors(tmp_path):
    """write_jpeg writes encode's bytes, PIL's file; bad inputs raise."""
    a = _smooth((24, 40, 3), 4)
    jpeg.write_jpeg(tmp_path / "a.jpg", a)
    assert (tmp_path / "a.jpg").read_bytes() == _pil_jpeg(a)
    assert (tmp_path / "a.jpg").read_bytes() == jpeg.encode(a)
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(a.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(np.zeros((4, 4, 4), np.uint8))


# -- a ScanNet scene's first run ------------------------------------------------

DEPTH_W, DEPTH_H = 64, 48
N_FRAMES = 3


def write_scannet_scene(root):
    """A ScanNet-layout scene: JPEG colour at ScanNet's 1296x968 aspect but
    cut to 2.03x the depth resolution (130x97, odd), 16-bit PNG depth in mm,
    poses, depth intrinsics and ORB-SLAM2 files."""
    scene = root / "scene0000_00"
    for sub in ("color", "depth", "pose", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    for i in range(N_FRAMES):
        PIL.Image.fromarray(_smooth((97, 130, 3), 10 + i)).save(scene / "color" / f"{i}.jpg")
        depth_mm = np.full((DEPTH_H, DEPTH_W), 1800 + 100 * i, np.uint16)
        PIL.Image.fromarray(depth_mm).save(scene / "depth" / f"{i}.png")
    poses = gt_poses(N_FRAMES)
    for i in range(N_FRAMES):
        np.savetxt(scene / "pose" / f"{i}.txt", poses[i] @ OGL2OCV.astype(np.float64))
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 50.0
    intr[0, 2], intr[1, 2] = 32.0, 24.0
    np.savetxt(scene / "intrinsic" / "intrinsic_depth.txt", intr)
    write_slam_files(scene, poses)
    return dict(root_dir=str(root), scene="scene0000_00", **SLAM_CONFIG)


_FIRST_RUN = _BLOCKER + """
import numpy as np
try:
    import PIL  # noqa: F401
    sys.exit("PIL is importable")
except ImportError:
    pass
from neural_graph_mapping_tpu_torch.datasets.scannet import ScanNetDataset

root = sys.argv[1]
ds = ScanNetDataset(dict(root_dir=root, scene="scene0000_00"))
np.save(root + "/frames.npy", np.stack([ds[i]["rgbd"] for i in range(len(ds))]))
"""


def test_scannet_first_run_without_pil_equals_jax(tmp_path):
    """The port's first run on a scene without ``aligned_color_to_depth/``,
    in a process where PIL (and PyYAML, JAX) cannot be imported, writes
    frames under the same names that decode to the same bytes as those the
    JAX package's first run writes with PIL, and loads the same RGB-D."""
    cfg = write_scannet_scene(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    want = JaxScanNet(cfg)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_RUN, str(tmp_path / "port")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    aligned = {name: tmp_path / name / "scene0000_00" / "aligned_color_to_depth" for name in ("jax", "port")}
    names = sorted(p.name for p in aligned["jax"].iterdir())
    assert names == sorted(p.name for p in aligned["port"].iterdir()) == [f"{i}.jpg" for i in range(N_FRAMES)]
    for name in names:
        got = jpeg.read_jpeg(aligned["port"] / name)
        assert got.shape == (DEPTH_H, DEPTH_W, 3)
        np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(aligned["jax"] / name)))
        assert (aligned["port"] / name).read_bytes() == (aligned["jax"] / name).read_bytes()
    frames = np.load(tmp_path / "port" / "frames.npy")
    np.testing.assert_array_equal(frames, np.stack([want[i]["rgbd"] for i in range(N_FRAMES)]))


def test_chip_smoke_scannet_config_equals_yaml():
    """chip_smoke.py writes config/scannet_dataset.yaml out (the card's
    machine may lack PyYAML) for its scannet_scene phase."""
    import chip_smoke

    from neural_graph_mapping_tpu_torch import config as tconfig

    assert chip_smoke.SCANNET_DATASET == tconfig.load_config("scannet_dataset.yaml")


def test_chip_smoke_scannet_scene_loads_without_pil(tmp_path):
    """The scannet_scene phase's scene writer at a cut size: colour through
    the port's encoder at twice the depth resolution, and the port's first
    load of it with PIL blocked gives frames of the depth size whose RGB is
    the colour frame resized (Lanczos) and re-encoded."""
    import chip_smoke

    frames, color, depth = 2, (64, 48), (32, 24)
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "SCANNET_FRAMES", frames)
    mp.setattr(chip_smoke, "SCANNET_COLOR", color)
    mp.setattr(chip_smoke, "SCANNET_DEPTH", depth)
    mp.setattr(chip_smoke, "SCANNET_FX", 28.0)
    try:
        written = chip_smoke.write_scannet_scene(tmp_path, workers=1)
    finally:
        mp.undo()
    scene = tmp_path / "scene0000_00"
    assert written["frames"] == frames and len(list((scene / "color").iterdir())) == frames
    assert not (scene / "aligned_color_to_depth").exists()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_RUN, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rgbd = np.load(tmp_path / "frames.npy")
    assert rgbd.shape == (frames, depth[1], depth[0], 4)
    raw = jpeg.read_jpeg(scene / "color" / "0.jpg")
    want = jpeg.decode(jpeg.encode(imageio.resize_lanczos(raw, depth)))
    np.testing.assert_array_equal(np.round(rgbd[0, ..., :3] * 255.0).astype(np.uint8), want)
    assert (rgbd[..., 3] > 0).mean() > 0.9
