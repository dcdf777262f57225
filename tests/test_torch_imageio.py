"""The port's PNG reader and writer (``utils/imageio.py``) against PIL:
byte-equal arrays on files PIL wrote (its encoder picks a filter a row), on
hand-built files with every scanline filter, on 16-bit depth above 32,767,
on odd widths, on one-pixel-wide and one-row images and on full-size
frames written with adaptive filters; files the port writes read back equal
in PIL. The native unfilter (``csrc/png.cpp``): unknown filter types raise,
two threads may load and run it at once, and ctypes runs it without the
GIL."""

import ctypes
import struct
import sys
import threading
import zlib

import numpy as np
import PIL.Image
import pytest

from neural_graph_mapping_tpu_torch.utils import imageio
from port_bench import pngwrite


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]  # odd width and height
    smooth = np.stack([(xx * 4) % 256, (yy * 5) % 256, (xx + yy + rng.integers(0, 9, xx.shape)) % 256], -1)
    return {
        "RGB": smooth.astype(np.uint8),
        "RGBA": rng.integers(0, 256, (21, 11, 4)).astype(np.uint8),
        "L": ((xx * yy) % 256).astype(np.uint8),
        "LA": rng.integers(0, 256, (9, 13, 2)).astype(np.uint8),
        # depth in mm and at Replica's scale 6553.5: values above 32,767
        "I;16": (30000 + (xx * 700 + yy * 90) % 35000).astype(np.uint16),
    }


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "I;16"])
def test_reads_what_pil_wrote(tmp_path, mode):
    arr = _images()[mode]
    path = tmp_path / "img.png"
    PIL.Image.fromarray(arr, None if mode != "LA" else "LA").save(path)
    want = np.asarray(PIL.Image.open(path))
    got = imageio.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert imageio.image_size(path) == PIL.Image.open(path).size


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(arr: np.ndarray, filters, ctype: int, depth: int, interlace: int = 0) -> bytes:
    """A PNG whose row r uses filters[r % len(filters)], encoded by the
    PNG specification's per-byte rules (a plain loop)."""
    h, w = arr.shape[:2]
    if depth == 16:
        rows = arr.astype(">u2").view(np.uint8).reshape(h, -1)
        bpp = 2
    else:
        rows = arr.reshape(h, -1).astype(np.uint8)
        bpp = rows.shape[1] // w
    rows = rows.astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r % len(filters)]
        out.append(f)
        for x in range(rows.shape[1]):
            a = rows[r, x - bpp] if x >= bpp else 0
            b = rows[r - 1, x] if r > 0 else 0
            c = rows[r - 1, x - bpp] if r > 0 and x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            out.append(int(rows[r, x] - pred) & 0xFF)
    return _png(w, h, depth, ctype, bytes(out), interlace)


def _png(w: int, h: int, depth: int, ctype: int, scanlines: bytes, interlace: int = 0) -> bytes:
    """A PNG of the given header whose IDAT inflates to ``scanlines``."""

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (imageio.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"tEXt", b"comment\x00a chunk to skip")
            + chunk(b"IDAT", zlib.compress(scanlines)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [2, 1, 0]])
@pytest.mark.parametrize("mode,ctype,depth", [("RGB", 2, 8), ("I;16", 0, 16), ("RGBA", 6, 8)])
def test_every_filter_type(tmp_path, filters, mode, ctype, depth):
    arr = _images()[mode][:9, :15]
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(arr, filters, ctype, depth))
    want = np.asarray(PIL.Image.open(path))
    assert np.array_equal(want, arr)
    got = imageio.read_png(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)


_MODES = {"L": (0, 8), "LA": (4, 8), "RGB": (2, 8), "RGBA": (6, 8), "I;16": (0, 16)}


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [3, 4, 1, 2, 0]])
@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("shape", [(1, 1), (6, 1), (1, 6)])
def test_one_pixel_wide_and_one_row(tmp_path, shape, mode, filters):
    """Images where "left" (one pixel wide) or "up" (one row) never exists,
    at 1-4 bytes a pixel and 16-bit."""
    src = _images()[mode]
    arr = np.resize(src, shape + src.shape[2:])
    ctype, depth = _MODES[mode]
    path = tmp_path / "edge.png"
    path.write_bytes(_filtered_png(arr, filters, ctype, depth))
    want = np.asarray(PIL.Image.open(path))
    assert np.array_equal(want, arr)
    got = imageio.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


def _frames():
    """A 640x480 RGB frame and a 16-bit depth frame whose rows the adaptive
    filter heuristic writes with every one of the five types."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:480, 0:640]
    rgb = np.stack([(xx // 3) % 256, (yy // 2) % 256, ((xx + yy) // 4) % 256], -1) + rng.integers(0, 3, (480, 640, 3))
    rgb[::7] = rng.integers(0, 256, rgb[::7].shape)
    band = yy // 96
    depth = np.select(
        [band == 0, band == 1, band == 2, band == 3],
        [np.full(xx.shape, 2500), 700 + xx * 13, rng.integers(0, 65536, xx.shape), 1000 + (xx * 3 + yy * 7) % 4000],
        30000 + ((xx - 320) ** 2 + (yy - 400) ** 2) // 9,
    )
    return {"rgb": (rgb.astype(np.uint8), 3), "depth": (depth.astype(np.uint16), 2)}


@pytest.mark.parametrize("name", ["rgb", "depth"])
def test_reads_adaptive_filtered_frames(tmp_path, name):
    """Full-size frames as the benchmark's lap writes them
    (``port_bench.pngwrite``): rows of Sub, Up, Average and Paeth mixed."""
    arr, bpp = _frames()[name]
    rows = arr.astype(">u2").view(np.uint8) if arr.dtype == np.uint16 else arr
    assert set(pngwrite.filter_rows(rows.reshape(480, -1), bpp)[:, 0]) == {0, 1, 2, 3, 4}
    path = tmp_path / f"{name}.png"
    pngwrite.write_png(path, arr)
    want = np.asarray(PIL.Image.open(path))
    got = imageio.read_png(path)
    assert got.dtype == arr.dtype and np.array_equal(got, arr) and np.array_equal(got, want)


def test_unknown_filter_type_raises(tmp_path):
    scan = bytes([0, 1, 2, 3]) + bytes([1, 5, 5, 5]) + bytes([5, 0, 0, 0]) + bytes([4, 1, 1, 1])
    path = tmp_path / "bad.png"
    path.write_bytes(_png(1, 4, 8, 2, scan))
    with pytest.raises(ValueError, match=r"bad\.png: unknown PNG filter type 5 in row 2"):
        imageio.read_png(path)


def test_two_threads_load_and_read_at_once(tmp_path, monkeypatch):
    """Two threads read the same files at once, the first time the library
    is loaded: it is loaded once and both read the files' arrays."""
    paths = {}
    for name, (arr, _) in _frames().items():
        paths[name] = tmp_path / f"{name}.png"
        pngwrite.write_png(paths[name], arr)
    loads = []

    class CountingCDLL(ctypes.CDLL):
        def __init__(self, *args, **kwargs):
            loads.append(args[0])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(imageio, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", CountingCDLL)
    start = threading.Barrier(2)
    results = [None, None]

    def read(i):
        start.wait(timeout=30)
        results[i] = [imageio.read_png(paths[name]) for _ in range(3) for name in ("rgb", "depth")]

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1
    frames = _frames()
    for got in results:
        assert got is not None and len(got) == 6
        for k, name in enumerate(("rgb", "depth") * 3):
            assert np.array_equal(got[k], frames[name][0])


def test_unfilter_runs_without_the_gil():
    """The library is a ``ctypes.CDLL``, not a ``ctypes.PyDLL``: ctypes
    releases the GIL for the length of each call into it."""
    lib = imageio._load()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
    assert not lib.ngm_png_unfilter._flags_ & ctypes._FUNCFLAG_PYTHONAPI


@pytest.mark.parametrize("filter_type", [0, 1])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "I;16"])
def test_written_files_read_equal_in_pil(tmp_path, mode, filter_type):
    arr = _images()[mode]
    path = tmp_path / "w.png"
    imageio.write_png(path, arr, filter_type=filter_type)
    assert np.array_equal(np.asarray(PIL.Image.open(path)), arr)
    assert np.array_equal(imageio.read_png(path), arr)


def test_out_of_scope_files_raise(tmp_path):
    pal = tmp_path / "p.png"
    PIL.Image.fromarray(_images()["L"]).convert("P").save(pal)
    with pytest.raises(ValueError, match="colour type 3"):
        imageio.read_png(pal)
    inter = tmp_path / "i.png"
    inter.write_bytes(_filtered_png(_images()["RGB"][:4, :4], [0], 2, 8, interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        imageio.read_png(inter)
    text = tmp_path / "t.png"
    text.write_text("not an image")
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.read_png(text)


def test_jpeg_goes_through_pil_and_names_the_file_without_it(tmp_path, monkeypatch):
    """JPEG frames no longer go through PIL: with PIL gone they read to
    PIL's array through the port's decoder (``utils/jpeg.py``). Formats that
    are neither PNG nor JPEG still go through PIL, and without it raise an
    ``ImportError`` that names the file."""
    jpg = tmp_path / "frame000001.jpg"
    PIL.Image.fromarray(_images()["RGB"]).save(jpg)
    want = np.asarray(PIL.Image.open(jpg))
    bmp = tmp_path / "frame000001.bmp"
    PIL.Image.fromarray(_images()["RGB"]).save(bmp)
    assert np.array_equal(imageio.read_image(bmp), np.asarray(PIL.Image.open(bmp)))
    assert imageio.image_size(jpg) == PIL.Image.open(jpg).size
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert np.array_equal(imageio.read_image(jpg), want)
    with pytest.raises(ImportError, match="frame000001.bmp.*PIL"):
        imageio.read_image(bmp)
    png = tmp_path / "depth.png"
    imageio.write_png(png, _images()["I;16"])
    assert np.array_equal(imageio.read_image(png), _images()["I;16"])
