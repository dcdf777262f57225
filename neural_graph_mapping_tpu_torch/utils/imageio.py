"""PNG reading and writing on numpy and ``zlib`` alone.

Every loader of the port reads its PNG frames through :func:`read_png`, on
every machine, so a machine without PIL (the card's) reads the same bytes
the same way. Scope: non-interlaced PNGs of 8-bit gray, gray + alpha, RGB
or RGBA, and 16-bit gray (depth frames); all five scanline filters on read.
:func:`write_png` writes the same formats with filter 0 (None) or 1 (Sub).
JPEG files (the colour frames of real Replica and ScanNet scenes) go to the
port's own decoder (``utils/jpeg.py``), also on every machine; other image
formats are read by :func:`read_image` through PIL, imported where such a
file is opened.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from neural_graph_mapping_tpu_torch.utils import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the colour types this module reads
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """PNG's Paeth predictor on int16 arrays of byte values."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """(height, 1 + width * bpp) filtered scanlines -> (height, width, bpp)
    uint8 bytes. Rows of filters 0-2 only are undone row by row, each row at
    once; where a row uses Average (3) or Paeth (4), whose predictor needs
    the row's own previous pixel, the whole image is undone along its
    anti-diagonals (pixel (r, x) depends on (r, x - 1), (r - 1, x) and
    (r - 1, x - 1) only), each diagonal at once."""
    filters = raw[:, 0]
    if filters.size and int(filters.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(filters.max())}")
    data = raw[:, 1:].reshape(height, width, bpp)
    out = np.empty((height, width, bpp), np.uint8)
    if not np.isin(filters, (3, 4)).any():
        prev = np.zeros((width, bpp), np.uint8)
        for r in range(height):
            f = filters[r]
            if f == 0:
                out[r] = data[r]
            elif f == 1:
                out[r] = np.cumsum(data[r], axis=0, dtype=np.uint8)
            else:
                out[r] = data[r] + prev
            prev = out[r]
        return out
    # one pixel of zeros above and to the left of the image
    rec = np.zeros((height + 1, width + 1, bpp), np.int16)
    filt = filters.astype(np.int16)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(d, height - 1) + 1)
        x = d - r
        a = rec[r + 1, x]  # left
        b = rec[r, x + 1]  # up
        c = rec[r, x]  # up-left
        fr = filt[r][:, None]
        pred = np.where(
            fr == 1, a, np.where(fr == 2, b, np.where(fr == 3, (a + b) >> 1, np.where(fr == 4, _paeth(a, b, c), 0)))
        )
        rec[r + 1, x + 1] = (data[r, x].astype(np.int16) + pred) & 0xFF
    out[:] = rec[1:, 1:]
    return out


def read_png(path: os.PathLike) -> np.ndarray:
    """A PNG file -> (H, W) for gray, (H, W, C) otherwise; uint8, or uint16
    for 16-bit gray. Raises ``ValueError`` for a file or a format outside
    this module's scope."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(
            f"{path}: PNG colour type {ctype} at bit depth {depth} is not read "
            "(8-bit gray / gray+alpha / RGB / RGBA and 16-bit gray are)"
        )
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: image data of {raw.size} bytes for {width}x{height}")
    pixels = _unfilter(raw.reshape(height, 1 + width * bpp), height, width, bpp)
    if depth == 16:
        return pixels.view(">u2").reshape(height, width).astype(np.uint16)
    return pixels[..., 0] if channels == 1 else pixels


def write_png(path: os.PathLike, image: np.ndarray, filter_type: int = 1) -> None:
    """Write (H, W) uint8 / uint16 gray or (H, W, C) uint8 gray + alpha / RGB
    / RGBA as a PNG, every row with ``filter_type`` 0 (None) or 1 (Sub)."""
    image = np.asarray(image)
    if filter_type not in (0, 1):
        raise ValueError(f"filter_type must be 0 or 1, got {filter_type}")
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, ctype, rows = 16, 0, image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1, 2)
    elif image.dtype == np.uint8 and image.ndim == 2:
        depth, ctype, rows = 8, 0, image[..., None]
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[-1] in (2, 3, 4):
        depth, ctype, rows = 8, {2: 4, 3: 2, 4: 6}[image.shape[-1]], image
    else:
        raise ValueError(f"cannot write a {image.dtype} image of shape {image.shape} as PNG")
    height, width = rows.shape[:2]
    rows = np.ascontiguousarray(rows)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, 1:] -= rows[:, :-1].copy()
    scan = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8), rows.reshape(height, -1)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scan.tobytes())))
        f.write(chunk(b"IEND", b""))


# fixed-point bits of PIL's 8-bit resampling coefficients (Resample.c)
_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _lanczos(x: float) -> float:
    """PIL's Lanczos-3 window: sinc(x) * sinc(x / 3) on [-3, 3)."""

    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a box of
    the whole axis -> (first input index (out,), taps (out,), fixed-point
    weights (out, ksize) int64). Scalar double arithmetic in PIL's order,
    with ``math.sin`` as libm's."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int(): C's truncation
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            w *= 1 << _PRECISION_BITS
            weights[xx, x] = int(w - 0.5) if w < 0 else int(w + 0.5)
        first[xx], taps[xx] = xmin, xmax
    return first, taps, weights


def _resample_axis0(img: np.ndarray, first, taps, weights) -> np.ndarray:
    """One 8-bit pass of PIL's resampler along axis 0 of ``img`` (n, ...)
    uint8 -> (out, ...) uint8: the fixed-point sum from half a unit, then
    ``clip8`` (the sum >> PRECISION_BITS, clipped to 0..255)."""
    ksize = weights.shape[1]
    idx = np.minimum(first[:, None] + np.arange(ksize)[None, :], img.shape[0] - 1)
    w = np.where(np.arange(ksize)[None, :] < taps[:, None], weights, 0)
    src = img.astype(np.int64)[idx]  # (out, ksize, ...)
    w = w.reshape(w.shape + (1,) * (img.ndim - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + np.sum(src * w, axis=1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(image: np.ndarray, size: tuple) -> np.ndarray:
    """``Image.resize(size, Resampling.LANCZOS)`` of an 8-bit gray (H, W) or
    colour (H, W, C) array, byte for byte as PIL's ``Resample.c`` computes
    it. ``size`` is (width, height), as PIL takes it.

    Two separable passes, horizontal first, each skipped where its axis
    keeps its size: per output pixel the window of support 3 * max(scale,
    1) centred at (i + 0.5) * scale, coefficients normalised to sum 1 and
    rounded to 22-bit fixed point, the sum clipped to 8 bits after each
    pass."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"resize_lanczos takes (H, W) or (H, W, C) uint8, got {image.dtype} {image.shape}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError(f"size must be positive, got {size}")
    in_h, in_w = image.shape[:2]
    out = image
    if out_w != in_w:
        # PIL's horizontal pass covers only the rows the vertical pass reads
        out = np.swapaxes(_resample_axis0(np.swapaxes(out, 0, 1), *_lanczos_coeffs(in_w, out_w)), 0, 1)
    if out_h != in_h:
        out = _resample_axis0(out, *_lanczos_coeffs(in_h, out_h))
    return np.ascontiguousarray(out)


def _pil_image(path: os.PathLike):
    """PIL's Image module, for a file that is not a PNG; without PIL an
    ``ImportError`` that names the file."""
    try:
        import PIL.Image
    except ImportError as e:
        raise ImportError(f"{path} is not a PNG; reading it needs PIL (Pillow), which is not installed") from e
    return PIL.Image


def read_image(path: os.PathLike) -> np.ndarray:
    """An image file as an array: PNGs through :func:`read_png`, JPEGs (SOI
    ``FF D8``) through :func:`jpeg.read_jpeg`, any other format through
    PIL."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == jpeg.SOI:
        return jpeg.read_jpeg(path)
    with _pil_image(path).open(path) as img:
        return np.asarray(img)


def image_size(path: os.PathLike) -> tuple:
    """(width, height) of an image file, as PIL's ``Image.size``; a PNG's
    from its header alone, a JPEG's from its frame header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    if head[:2] == jpeg.SOI:
        return jpeg.jpeg_size(path)
    with _pil_image(path).open(path) as img:
        return img.size
