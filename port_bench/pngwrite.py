"""PNG files written the way datasets are written: each row with the filter
whose bytes have the least sum of absolute values (as signed bytes), the
heuristic libpng and PIL apply by default, so rows take Sub, Up, Average
and Paeth as the image's content chooses. 8-bit RGB and 16-bit gray."""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, W * bpp) uint8 scanlines -> (H, 1 + W * bpp) uint8: each row's
    filter type byte, then the row filtered by the type of least cost."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]).astype(np.uint8)  # mod 256
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)  # (5, H)
    best = np.argmin(cost, axis=0)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cands[best, np.arange(rows.shape[0])]
    return out


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 or (H, W) uint16 -> PNG bytes."""
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, ctype, rows, bpp = 8, 2, image.reshape(image.shape[0], -1), 3
    elif image.dtype == np.uint16 and image.ndim == 2:
        depth, ctype, bpp = 16, 0, 2
        rows = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    else:
        raise ValueError(f"cannot write {image.dtype} {image.shape} as a PNG")
    h, w = image.shape[:2]
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    data = zlib.compress(filter_rows(np.ascontiguousarray(rows), bpp).tobytes(), 6)
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", data) + _chunk(b"IEND", b"")


def write_png(path: pathlib.Path, image: np.ndarray) -> int:
    """Write ``image`` to ``path`` -> bytes written."""
    data = encode_png(image)
    pathlib.Path(path).write_bytes(data)
    return len(data)
