"""The replay lap's PNG writer: adaptive filters, decoded back exactly."""

import numpy as np
import pytest

from port_bench import manifest as mf
from port_bench import pngwrite, scene


@pytest.fixture(scope="module")
def frame():
    sc = dict(mf.load_config("ngm_multiview_640")["scene"], width=64, height=48, fx=56.0, fy=56.0, lap_frames=8)
    frames, _ = scene.cast_lap(sc, "cpu", [3])
    f = frames[3]
    return (np.round(f[..., :3] * 255.0).astype(np.uint8), np.round(f[..., 3] * 1000.0).astype(np.uint16))


def test_written_png_decodes_to_the_frame_it_was_given(frame, tmp_path):
    from neural_graph_mapping_tpu_torch.utils import imageio

    rgb, depth = frame
    for image, name in ((rgb, "img.png"), (depth, "depth.png")):
        pngwrite.write_png(tmp_path / name, image)
        got = imageio.read_image(tmp_path / name)
        assert got.dtype == image.dtype and np.array_equal(got, image)


def test_rows_take_the_filter_of_least_cost(frame):
    rgb, _ = frame
    rows = rgb.reshape(rgb.shape[0], -1)
    filtered = pngwrite.filter_rows(rows, 3)
    assert set(np.unique(filtered[:, 0])) - {0, 1, 2, 3, 4} == set()
    assert len(np.unique(filtered[:, 0])) >= 2  # the content picks more than one
    noise = np.random.default_rng(0).integers(0, 256, (16, 30), dtype=np.uint8)
    assert pngwrite.filter_rows(noise, 3).shape == (16, 31)
    ramp = np.tile(np.arange(30, dtype=np.uint8), (4, 1))
    assert list(pngwrite.filter_rows(ramp, 3)[1:, 0]) == [2, 2, 2]  # each row equals the one above
