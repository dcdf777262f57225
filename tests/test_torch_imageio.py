"""The port's PNG reader and writer (``utils/imageio.py``) against PIL:
byte-equal arrays on files PIL wrote (its encoder picks a filter a row), on
hand-built files with every scanline filter, on 16-bit depth above 32,767
and on odd widths; files the port writes read back equal in PIL."""

import struct
import sys
import zlib

import numpy as np
import PIL.Image
import pytest

from neural_graph_mapping_tpu_torch.utils import imageio


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

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (imageio.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"tEXt", b"comment\x00a chunk to skip")
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


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
