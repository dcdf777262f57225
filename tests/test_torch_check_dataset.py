"""The port's check_dataset (``neural_graph_mapping_tpu_torch.scripts.check_dataset``)
on the layouts of ``tests/test_torch_datasets.py``: the cases of
``tests/test_check_dataset.py`` (four layouts pass, a depth stored in
metres and missing poses are flagged, an unknown layout prints usage), its
loader round-trip through the port's loaders; and a Replica scene with PNG
colour frames passes, as the port's loader reads it."""

import numpy as np
import pytest

from test_torch_datasets import H, W, write_kintinuous, write_nrgbd, write_replica, write_scannet

from neural_graph_mapping_tpu_torch.scripts import check_dataset
from neural_graph_mapping_tpu_torch.utils import imageio


@pytest.mark.parametrize("layout,write,scene", [
    ("nrgbd", write_nrgbd, "whiteroom"),
    ("replica", write_replica, "office0"),
    ("scannet", write_scannet, "scene0000_00"),
    ("kintinuous", write_kintinuous, "loop"),
])
def test_layout_passes(tmp_path, capsys, layout, write, scene):
    write(tmp_path)
    assert check_dataset.main([layout, str(tmp_path), scene]) == 0
    out = capsys.readouterr().out
    assert "ALL CHECKS PASSED" in out and "[FAIL]" not in out


def test_replica_png_frames_pass(tmp_path):
    write_replica(tmp_path, ext="png")
    assert check_dataset.main(["replica", str(tmp_path), "office0"]) == 0


def test_bad_depth_scale_flagged(tmp_path, capsys):
    """Depth stored in metres (values ~2) instead of mm trips the depth-scale
    check."""
    write_nrgbd(tmp_path)
    for p in (tmp_path / "whiteroom" / "depth_filtered").glob("*.png"):
        imageio.write_png(p, np.full((H, W), 2, np.uint16))
    assert check_dataset.main(["nrgbd", str(tmp_path), "whiteroom"]) == 1
    assert "[FAIL] depth scale sane" in capsys.readouterr().out


def test_missing_poses_flagged(tmp_path, capsys):
    write_nrgbd(tmp_path)
    (tmp_path / "whiteroom" / "poses.txt").unlink()
    assert check_dataset.main(["nrgbd", str(tmp_path), "whiteroom"]) == 1
    assert "[FAIL] poses.txt exists" in capsys.readouterr().out


def test_unknown_layout_usage(capsys):
    assert check_dataset.main(["nonsense", "/tmp", "x"]) == 2
    assert "Usage" in capsys.readouterr().out
