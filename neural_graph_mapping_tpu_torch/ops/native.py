"""ctypes bindings for the host-side geometry code in C++ (port of
neural_graph_mapping_tpu.ops.native).

Both packages share the source ``native/src/ngm_native.cpp``; this module
builds its own copy with ``g++`` at first use into the port's ``_build/``
(named by a hash of the source and the flags, written under a temporary
name and moved into place, so concurrent processes never load a half-written
library) and exposes:

- :func:`marching_tetrahedra`: isosurface extraction from a volume block;
- :func:`rasterize_depth`: double-sided depth rasterization for culling.

:func:`built_library` builds the port's other host sources the same way
(``csrc/jpeg.cpp``, ``utils/jpeg.py``).

A failed build raises; there is no other implementation to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "src" / "ngm_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags, so both builds of the source round alike
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path(source: pathlib.Path = SOURCE, stem: str = "libngm_native", flags=CXX_FLAGS) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def built_library(source: pathlib.Path, stem: str, flags=CXX_FLAGS) -> pathlib.Path:
    """``_build/<stem>-<hash>.so`` built from ``source`` with ``flags`` (the
    hash covers both), built with ``g++`` if it is not there: written under a
    temporary name and moved into place. A failed build raises."""
    path = library_path(source, stem, flags)
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *flags, "-o", tmp, str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(built_library(SOURCE, "libngm_native")))
        lib.marching_tetrahedra.restype = ctypes.c_int
        lib.marching_tetrahedra.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # grid
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nx ny nz
            ctypes.c_float,  # iso
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # verts_out, max_verts
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,  # tris_out, max_tris
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.rasterize_depth.restype = None
        lib.rasterize_depth.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # verts
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # tris
            ctypes.POINTER(ctypes.c_float),  # w2c
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int,  # width height
            ctypes.POINTER(ctypes.c_float),  # depth_out
        ]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def marching_tetrahedra(grid: np.ndarray, isolevel: float) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of an (nx, ny, nz) float32 grid.

    Returns:
        verts: (V, 3) float32 in continuous grid-index coordinates (x, y, z).
        tris: (T, 3) int32 vertex indices.
    """
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    lib = _load()
    max_verts = max(1024, 4 * int(np.prod(grid.shape[:2])) * 16)
    max_tris = 2 * max_verts
    while True:
        verts = np.empty((max_verts, 3), np.float32)
        tris = np.empty((max_tris, 3), np.int32)
        nv = ctypes.c_int(0)
        nt = ctypes.c_int(0)
        status = lib.marching_tetrahedra(
            _fptr(grid), nx, ny, nz, ctypes.c_float(isolevel),
            _fptr(verts), max_verts, _iptr(tris), max_tris,
            ctypes.byref(nv), ctypes.byref(nt),
        )
        if status == 0:
            return verts[: nv.value].copy(), tris[: nt.value].copy()
        max_verts *= 2
        max_tris *= 2


def rasterize_depth(
    verts: np.ndarray,
    tris: np.ndarray,
    w2c: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
) -> np.ndarray:
    """Double-sided z-buffer depth map of a mesh from an OpenCV pinhole camera.

    Args:
        verts: (V, 3) float32 world vertices. tris: (T, 3) int32.
        w2c: (4, 4) world-to-camera (OpenCV convention: z forward).

    Returns:
        (height, width) float32 depth (0 where empty).
    """
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    w2c = np.ascontiguousarray(w2c, dtype=np.float32)
    depth = np.zeros((height, width), np.float32)
    lib = _load()
    lib.rasterize_depth(
        _fptr(verts), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
        _fptr(w2c),
        ctypes.c_float(fx), ctypes.c_float(fy), ctypes.c_float(cx), ctypes.c_float(cy),
        width, height, _fptr(depth),
    )
    return depth
