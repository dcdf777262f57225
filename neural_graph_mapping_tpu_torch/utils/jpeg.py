"""JPEG reading without PIL: ctypes bindings for ``csrc/jpeg.cpp``.

The decoder takes sequential Huffman JPEGs (SOF0 baseline and SOF1
extended) of 8-bit samples, gray or three components (YCbCr, or RGB by the
Adobe / component-id convention), sampling 4:4:4, 4:2:2 or 4:2:0, with or
without restart intervals: the colour frames of Replica and ScanNet. It
follows the IJG library's default decompression arithmetic (integer IDCT,
fancy upsampling, fixed-point colour tables), so its bytes equal PIL's,
which decodes through libjpeg-turbo. Progressive, arithmetic-coded,
lossless, hierarchical, 12-bit and four-component files raise a
``ValueError`` that names the file and the marker; nothing falls back to
PIL.

The library is built with ``g++`` at first use into the port's ``_build/``
(``ops.native.built_library``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading

import numpy as np

from neural_graph_mapping_tpu_torch.ops import native

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "jpeg.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
SOI = b"\xff\xd8"

_lock = threading.Lock()
_lib = None
_ERR_LEN = 512


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.built_library(SOURCE, "libngm_jpeg", CXX_FLAGS)))
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.ngm_jpeg_info.restype = ctypes.c_int
            lib.ngm_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.ngm_jpeg_decode.restype = ctypes.c_int
            lib.ngm_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def _info(data: bytes, name) -> tuple:
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _load().ngm_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return w.value, h.value, c.value


def decode(data: bytes, name="<bytes>") -> np.ndarray:
    """A JPEG's bytes -> (H, W) uint8 gray or (H, W, 3) uint8 RGB, as PIL's
    ``np.asarray(Image.open(...))`` gives them. ``name`` goes into errors."""
    w, h, c = _info(data, name)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _load().ngm_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: os.PathLike) -> np.ndarray:
    """Decode the JPEG file at ``path`` (see :func:`decode`)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def jpeg_size(path: os.PathLike) -> tuple:
    """(width, height) from a JPEG's frame header."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, _ = _info(data, path)
    return w, h
