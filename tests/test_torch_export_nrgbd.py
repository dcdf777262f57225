"""The port's NRGBD scene exporter
(``neural_graph_mapping_tpu_torch.scripts.export_synthetic_nrgbd``) against
the JAX package's (scripts/refrun/export_synthetic_nrgbd.py, loaded by
path): 6 frames at 64x48, fx 56. The port's runs with JAX and PIL blocked
from import; the decoded frames are bit-equal, ``poses.txt`` is equal, and
both packages' NRGBD loaders read both exports alike. Also: the smoke's
fps960 / refrun_synthetic configs are config/fps960.yaml and
config/refrun_synthetic.yaml, and the runner's eval details are written
without PIL or tabulate as they would be with them."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from test_torch_no_jax import _BLOCKER

import chip_smoke
from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
from neural_graph_mapping_tpu_torch import config as tconfig
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.utils import imageio

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES, W, H, FX = 6, 64, 48, 56.0

_EXPORT_PROBE = _BLOCKER + """
from neural_graph_mapping_tpu_torch.scripts import export_synthetic_nrgbd

export_synthetic_nrgbd.main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
sys.exit(1 if leaked else 0)
"""


def _jax_exporter():
    spec = importlib.util.spec_from_file_location("jax_export_nrgbd", ROOT / "scripts/refrun/export_synthetic_nrgbd.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{"port": root, "jax": root}: the same scene through each exporter;
    the port's in a process where JAX and PIL cannot be imported, with two
    worker processes."""
    base = tmp_path_factory.mktemp("nrgbd_export")
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_PROBE, str(base / "port"), str(FRAMES), str(W), str(H), str(FX),
         "--workers", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"frames": 6' in proc.stdout and '"workers": 2' in proc.stdout
    _jax_exporter().export(base / "jax", FRAMES, W, H, FX)
    return {"port": base / "port", "jax": base / "jax"}


def _frame_files(root: pathlib.Path, i: int):
    scene = root / "synthetic"
    return scene / "images" / f"img{i:04d}.png", scene / "depth" / f"depth{i:04d}.png"


def test_port_export_equals_jax_export(exports):
    """Every frame decodes to the same uint8 RGB and uint16 depth (PIL on
    both exports), poses.txt is the same text, and the port's reader reads
    the JAX exporter's PIL-written files to PIL's arrays."""
    for i in range(FRAMES):
        for port_file, jax_file in zip(_frame_files(exports["port"], i), _frame_files(exports["jax"], i)):
            want = np.asarray(PIL.Image.open(jax_file))
            got = np.asarray(PIL.Image.open(port_file))
            assert got.dtype == want.dtype and want.dtype in (np.uint8, np.uint16)
            np.testing.assert_array_equal(got, want, err_msg=port_file.name)
            np.testing.assert_array_equal(imageio.read_png(port_file), want)
            np.testing.assert_array_equal(imageio.read_png(jax_file), want)
    assert (exports["port"] / "synthetic/poses.txt").read_text() == (exports["jax"] / "synthetic/poses.txt").read_text()
    assert sorted(p.name for p in (exports["port"] / "synthetic").rglob("*")) == sorted(
        p.name for p in (exports["jax"] / "synthetic").rglob("*"))


def _loader_config(root: pathlib.Path) -> dict:
    """config/fps960.yaml's dataset_config, its root replaced and its
    camera scaled to the 64x48 export (principal point at the centre,
    pixel_center 0.0 as the YAML has it)."""
    dcfg = tconfig.load_config("fps960.yaml")["dataset_config"]
    camera = dict(dcfg["camera"], width=W, height=H, fx=FX, fy=FX, cx=W / 2, cy=H / 2)
    return dict(dcfg, root_dir=str(root), camera=camera)


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_both_loaders_read_each_export_alike(exports, exporter):
    """JAX's NRGBDDataset and the port's give equal ``rgbd`` and ``c2w`` for
    every frame of the export, and the camera the YAML names."""
    cfg = _loader_config(exports[exporter])
    jds, ds = JaxNRGBD(cfg), NRGBDDataset(cfg)
    assert len(jds) == len(ds) == FRAMES
    for i in range(FRAMES):
        np.testing.assert_array_equal(ds[i]["rgbd"], np.asarray(jds[i]["rgbd"]))
        np.testing.assert_array_equal(ds[i]["c2w"], np.asarray(jds[i]["c2w"]))
    assert (ds.camera.fx, ds.camera.cx, ds.camera.cy) == (jds.camera.fx, jds.camera.cx, jds.camera.cy)


def test_smoke_configs_equal_the_yaml(tmp_path, monkeypatch):
    """chip_smoke.py writes config/fps960.yaml and
    config/refrun_synthetic.yaml out (the card's machine has no PyYAML):
    merged onto config/neural_graph_map.yaml they equal what the loader
    gives for the files; its run configs differ from those only in the
    scene's root (no other cut), and its exports are the YAML headers'."""
    monkeypatch.delenv("NGM_DATA_DIR", raising=False)
    model = tconfig.load_config("neural_graph_map.yaml")
    for scene, name in ((chip_smoke.FPS960, "fps960.yaml"), (chip_smoke.REFRUN_SYNTHETIC, "refrun_synthetic.yaml")):
        want = tconfig.load_config(name, model)
        assert chip_smoke.nrgbd_run_config(scene) == want
        run = chip_smoke.nrgbd_run_config(scene, tmp_path)
        assert run["dataset_config"] == dict(want["dataset_config"], root_dir=str(tmp_path))
        assert {k: v for k, v in run.items() if k != "dataset_config"} == {
            k: v for k, v in want.items() if k != "dataset_config"}
    header = (ROOT / "config/fps960.yaml").read_text()
    assert "export_synthetic_nrgbd.py /tmp/ngm_fps960 960 640 480 560.0" in header
    assert chip_smoke.FPS960_EXPORT == (960, 640, 480, 560.0)
    cam = chip_smoke.REFRUN_SYNTHETIC["dataset_config"]["camera"]
    assert chip_smoke.REFRUN_EXPORT == (120, cam["width"], cam["height"], cam["fx"])


def test_smoke_paeth_writer_reads_back(tmp_path):
    """The smoke's Paeth-row PNG writer (the decode-time probe of PIL-style
    files) writes files that PIL and the port's reader read to the array."""
    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 256, (9, 13, 3), dtype=np.uint8), rng.integers(0, 65536, (7, 5), dtype=np.uint16),
                rng.integers(0, 256, (4, 6), dtype=np.uint8)):
        path = tmp_path / f"paeth_{arr.dtype}_{arr.ndim}.png"
        chip_smoke.write_png_paeth(path, arr)
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(path)), arr)
        np.testing.assert_array_equal(imageio.read_png(path), arr)
        assert path.read_bytes()[8:].find(b"IDAT") > 0


_DETAILS_PROBE = _BLOCKER + """
import numpy as np
from neural_graph_mapping_tpu_torch.utils import chunking

rows = [["000005_000119.png", 12.345678, 0.1234], ["000010_000119.png", 8.0, 1.5e-05],
        ["x.png", float("nan"), 123456789.0]]
out = sys.argv[1]
chunking.save_image(np.load(out + "/img.npy"), out + "/img.png")
open(out + "/details.txt", "w").write(chunking.format_table(rows, ["filename", "psnr", "depthl1"]))
"""


def test_eval_details_without_pil_or_tabulate(tmp_path):
    """The runner's eval artefacts with PIL and tabulate blocked: the
    comparison PNG decodes to the array PIL would have saved, and the
    details table is tabulate's text for the same rows."""
    import tabulate

    img = np.random.default_rng(1).random((12, 20, 3)).astype(np.float32)
    np.save(tmp_path / "img.npy", img)
    proc = subprocess.run([sys.executable, "-c", _DETAILS_PROBE, str(tmp_path)], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "img.png")),
                                  (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    rows = [["000005_000119.png", 12.345678, 0.1234], ["000010_000119.png", 8.0, 1.5e-05],
            ["x.png", float("nan"), 123456789.0]]
    assert (tmp_path / "details.txt").read_text() == tabulate.tabulate(rows, headers=["filename", "psnr", "depthl1"])


@pytest.mark.parametrize("seed", range(4))
def test_format_table_equals_tabulate(seed):
    """chunking.format_table against tabulate on random rows of a file name
    and floats (integral, tiny, huge, negative, nan, inf)."""
    import tabulate

    from neural_graph_mapping_tpu_torch.utils import chunking

    rng = np.random.default_rng(seed)
    special = [0.0, 8.0, -3.25, 1.5e-05, 123456789.0, float("nan"), float("inf"), 1e16, 0.5]
    for _ in range(200):
        cols = int(rng.integers(1, 5))
        headers = ["filename"] + [str(rng.choice(["psnr", "depthl1", "ssim", "x"])) for _ in range(cols)]
        rows = [[str(rng.choice(["a.png", "000005_000119.png"]))]
                + [float(rng.choice(special)) if rng.random() < 0.4
                   else float(rng.uniform(-100, 100) * 10.0 ** rng.integers(-6, 7)) for _ in range(cols)]
                for _ in range(int(rng.integers(1, 5)))]
        assert chunking.format_table(rows, headers) == tabulate.tabulate(rows, headers=headers)
