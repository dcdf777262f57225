"""The port's JPEG decoder (``utils/jpeg.py``, ``csrc/jpeg.cpp``) against
PIL, which decodes through libjpeg-turbo: the decoder follows libjpeg's
default arithmetic, so every case below must equal PIL's array byte for
byte (no case needs a tolerance)."""

import io
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from neural_graph_mapping_tpu_torch.utils import imageio, jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _picture(h: int, w: int, channels: int, seed: int = 0) -> np.ndarray:
    """Smooth colour waves plus noise: both flat and busy 8x8 blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(channels)], -1)
    out = np.clip(base + rng.normal(0.0, 25.0, base.shape), 0, 255).astype(np.uint8)
    return out if channels == 3 else out[..., 0]


def _encode(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_decode_equals_pil_on_odd_sizes(mode, quality):
    """37x23 (neither side a multiple of 8 or 16): gray, and RGB at
    subsampling 0 (4:4:4), 1 (4:2:2) and 2 (4:2:0)."""
    gray = mode == "gray"
    arr = _picture(23, 37, 1 if gray else 3, seed=quality)
    kw = {} if gray else {"subsampling": {"444": 0, "422": 1, "420": 2}[mode]}
    data = _encode(arr, quality=quality, **kw)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == arr.shape
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (9, 17), (64, 48)])
def test_decode_equals_pil_on_small_and_aligned_sizes(shape):
    """Chroma planes of one or two samples take libjpeg's box replication
    instead of the fancy filter."""
    for subsampling in (0, 1, 2):
        data = _encode(_picture(*shape, 3, seed=shape[1]), quality=75, subsampling=subsampling)
        np.testing.assert_array_equal(jpeg.decode(data), _pil(data), err_msg=f"{shape} {subsampling}")


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=3), dict(restart_marker_rows=1),
                                dict(restart_marker_blocks=1, subsampling=0)],
                         ids=["every_3_mcus", "every_mcu_row", "every_mcu_444"])
def test_restart_markers(kw):
    data = _encode(np.random.default_rng(1).integers(0, 256, (45, 67, 3), dtype=np.uint8), quality=80, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(jpeg.decode(data), _pil(data))


def test_replica_sized_frame(tmp_path):
    """A 1200x680 4:2:0 frame, PIL's default as Replica's frames are,
    through ``imageio.read_image`` and ``image_size``."""
    path = tmp_path / "frame000000.jpg"
    PIL.Image.fromarray(_picture(680, 1200, 3, seed=7)).save(path, quality=90)
    got = imageio.read_image(path)
    np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path)))
    assert imageio.image_size(path) == (1200, 680) == jpeg.jpeg_size(path)


def test_refused_files_name_the_file_and_marker(tmp_path):
    arr = _picture(24, 32, 3)
    prog = tmp_path / "progressive.jpg"
    prog.write_bytes(_encode(arr, progressive=True))
    with pytest.raises(ValueError, match=r"progressive\.jpg: progressive JPEG \(0xFFC2\)"):
        imageio.read_image(prog)
    data = bytearray(_encode(arr))
    sof = data.index(b"\xff\xc0")
    twelve = tmp_path / "twelve.jpg"
    twelve.write_bytes(bytes(data[: sof + 4]) + bytes([12]) + bytes(data[sof + 5:]))
    with pytest.raises(ValueError, match=r"twelve\.jpg: 12-bit samples \(0xFFC0\)"):
        jpeg.read_jpeg(twelve)
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(bytes(data[:sof]) + b"\xff\xc9" + bytes(data[sof + 2:]))
    with pytest.raises(ValueError, match=r"arith\.jpg: arithmetic-coded JPEG \(0xFFC9\)"):
        jpeg.read_jpeg(arith)
    cmyk = tmp_path / "cmyk.jpg"
    PIL.Image.fromarray(arr).convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match=r"cmyk\.jpg: 4 components"):
        jpeg.read_jpeg(cmyk)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\xff\xd9 nothing", "x")


_NO_PIL = """
import sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Blocker())
import numpy as np
from neural_graph_mapping_tpu_torch.utils import imageio
np.save(sys.argv[2], imageio.read_image(sys.argv[1]))
"""


def test_reads_without_pil(tmp_path):
    """With PIL blocked from import (as on a machine without it), a JPEG
    reads to PIL's array."""
    path = tmp_path / "frame.jpg"
    arr = _picture(30, 41, 3, seed=3)
    path.write_bytes(_encode(arr, quality=85))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PIL, str(path), str(tmp_path / "got.npy")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy"), np.asarray(PIL.Image.open(path)))
