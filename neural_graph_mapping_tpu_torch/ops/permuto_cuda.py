"""CUDA kernels of the training path, with their plain PyTorch versions.

Counterpart of ``neural_graph_mapping_tpu/ops/permuto_pallas.py`` for the
three Pallas kernels the online frame step reaches:

============================  ============================================
wrapper here                  replaces (JAX package)
============================  ============================================
:func:`encode_fwd`            ``permuto_pallas.encode_fwd``
:func:`encode_bwd_table`      ``permuto_pallas.encode_bwd_table``
:func:`batched_gather`        ``permuto_pallas.batched_gather``
============================  ============================================

The kernels live in ``csrc/permuto.cu``. They are compiled with ``nvcc`` for
sm_90a into ``_build/`` at first use (a plain C interface, bound with
ctypes) and launched on PyTorch's current stream. Each wrapper takes the
plain version only for a CPU tensor; for a CUDA tensor it launches the kernel
or raises. ``LAUNCHES`` counts kernel launches (plain-version calls do not
count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional, Tuple

import torch

from neural_graph_mapping_tpu_torch.ops import permuto

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "permuto.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {"encode_fwd": 0, "encode_bwd_table": 0, "batched_gather": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Library:
    """The built shared library, its build time and the compiler's report."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, build_log: str) -> None:
        self.lib = lib
        self.build_seconds = build_seconds
        self.build_log = build_log


_LIBRARY: Optional[_Library] = None


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def load_library() -> _Library:
    """Build ``csrc/permuto.cu`` (once per source content) and load it."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libngm_permuto_{tag}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True, check=False,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    ptr, i32, c_int_p, c_float_p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    enc_args = [ptr, ptr, ptr, i32, i32, i32, i32, c_float_p, c_float_p, c_float_p, c_int_p, ptr]
    lib.ngm_encode_fwd.argtypes = enc_args
    lib.ngm_encode_fwd.restype = i32
    lib.ngm_encode_bwd_table.argtypes = enc_args
    lib.ngm_encode_bwd_table.restype = i32
    lib.ngm_batched_gather.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ngm_batched_gather.restype = i32
    _LIBRARY = _Library(lib, build_seconds, log)
    return _LIBRARY


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _route(*tensors: torch.Tensor) -> str:
    """'cuda' or 'cpu' for tensors that all lie on one such device; raise else."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        if dev.index is not None and dev.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {dev}, current device is {torch.cuda.current_device()}")
        return "cuda"
    if dev.type == "cpu":
        return "cpu"
    raise ValueError(f"unsupported device {dev}")


def _lattice_consts(scales, shifts, elev, t_size, n_levels: int):
    caps = permuto.normalize_capacities(t_size, n_levels)
    if len(scales) != n_levels or len(shifts) != n_levels:
        raise ValueError("scales/shifts do not match the table's level count")
    return (
        (ctypes.c_float * n_levels)(*scales),
        (ctypes.c_float * (3 * n_levels))(*(x for row in shifts for x in row)),
        (ctypes.c_float * 3)(*elev),
        (ctypes.c_int * n_levels)(*caps),
    )


def _const_tensors(scales, shifts, elev, device):
    f32 = torch.float32
    return (
        torch.tensor(scales, dtype=f32, device=device),
        torch.tensor(shifts, dtype=f32, device=device),
        torch.tensor(elev, dtype=f32, device=device),
    )


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- encode_fwd -----------------------------------------------------------------


def encode_fwd_plain(table, coords, scales, shifts, elev, t_size) -> torch.Tensor:
    """Plain PyTorch encode: table (..., 2, L, T), coords (..., 3, P) -> (..., 2L, P)."""
    s, sh, el = _const_tensors(scales, shifts, elev, coords.device)
    idx, w = permuto.lattice_keys_and_weights_soa(coords.unbind(-2), s, sh, el, t_size)
    return permuto.gather_blend(table, idx, w)


def encode_fwd(table, coords, scales, shifts, elev, t_size) -> torch.Tensor:
    """Fused permutohedral encode. table (..., 2, L, T) feature-major,
    coords (..., 3, P) -> (..., 2L, P) with row 2l+f (permuto_pallas.encode_fwd)."""
    lead = coords.shape[:-2]
    if coords.shape[-2] != 3 or table.shape[:-3] != lead or table.shape[-3] != 2:
        raise ValueError(f"shapes table {tuple(table.shape)} / coords {tuple(coords.shape)}")
    _check_f32("table", table)
    _check_f32("coords", coords)
    n_levels, t = table.shape[-2], table.shape[-1]
    caps = permuto.normalize_capacities(t_size, n_levels)
    if max(caps) > t:
        raise ValueError(f"level capacity {max(caps)} exceeds table size {t}")
    if _route(table, coords) == "cpu":
        return encode_fwd_plain(table, coords, scales, shifts, elev, caps)
    p = coords.shape[-1]
    b = int(torch.Size(lead).numel())
    out = torch.empty(lead + (2 * n_levels, p), dtype=torch.float32, device=coords.device)
    if b * p == 0:
        return out
    consts = _lattice_consts(scales, shifts, elev, caps, n_levels)
    lib = load_library().lib
    rc = lib.ngm_encode_fwd(
        table.data_ptr(), coords.data_ptr(), out.data_ptr(), b, p, n_levels, t,
        *consts, _stream(coords),
    )
    _check(rc, "encode_fwd")
    LAUNCHES["encode_fwd"] += 1
    return out


# -- encode_bwd_table -----------------------------------------------------------


def encode_bwd_table_plain(coords, g, scales, shifts, elev, t_size, table_size: int) -> torch.Tensor:
    """Plain table gradient: coords (..., 3, P), g (..., 2L, P) -> (..., 2, L, T)."""
    s, sh, el = _const_tensors(scales, shifts, elev, coords.device)
    idx, w = permuto.lattice_keys_and_weights_soa(coords.unbind(-2), s, sh, el, t_size)
    lead = coords.shape[:-2]
    n_levels, k, p = idx.shape[-3:]
    g_r = g.reshape(lead + (n_levels, 2, 1, p))
    gv = (w[..., None, :, :] * g_r).reshape(lead + (n_levels, 2, k * p))
    grad = permuto._table_grad_fallback(idx, gv, table_size)  # (..., L, 2, T)
    return grad.transpose(-3, -2).contiguous()


def encode_bwd_table(coords, g, scales, shifts, elev, t_size) -> torch.Tensor:
    """Table gradient of :func:`encode_fwd`: coords (..., 3, P), g (..., 2L, P)
    -> (..., 2, L, T), T = max(t_size) (permuto_pallas.encode_bwd_table)."""
    lead = coords.shape[:-2]
    n_levels = len(scales)
    caps = permuto.normalize_capacities(t_size, n_levels)
    t = max(caps)
    if coords.shape[-2] != 3 or g.shape != lead + (2 * n_levels, coords.shape[-1]):
        raise ValueError(f"shapes coords {tuple(coords.shape)} / g {tuple(g.shape)}")
    _check_f32("coords", coords)
    _check_f32("g", g)
    if _route(coords, g) == "cpu":
        return encode_bwd_table_plain(coords, g, scales, shifts, elev, caps, t)
    p = coords.shape[-1]
    b = int(torch.Size(lead).numel())
    grad = torch.zeros(lead + (2, n_levels, t), dtype=torch.float32, device=coords.device)
    if b * p == 0:
        return grad
    consts = _lattice_consts(scales, shifts, elev, caps, n_levels)
    lib = load_library().lib
    rc = lib.ngm_encode_bwd_table(
        coords.data_ptr(), g.data_ptr(), grad.data_ptr(), b, p, n_levels, t,
        *consts, _stream(coords),
    )
    _check(rc, "encode_bwd_table")
    LAUNCHES["encode_bwd_table"] += 1
    return grad


# -- batched_gather -------------------------------------------------------------


def batched_gather_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = values[b, idx[b, m]]."""
    return torch.gather(values, 1, idx)


def batched_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched flat gather: values (B, N) f32, idx (B, M) int64 in [0, N)
    -> (B, M) f32 (permuto_pallas.batched_gather, without its max-pooling)."""
    if values.ndim != 2 or idx.ndim != 2 or idx.shape[0] != values.shape[0]:
        raise ValueError(f"shapes values {tuple(values.shape)} / idx {tuple(idx.shape)}")
    _check_f32("values", values)
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise TypeError("idx must be contiguous int64")
    if _route(values, idx) == "cpu":
        return batched_gather_plain(values, idx)
    b, n = values.shape
    m = idx.shape[1]
    out = torch.empty((b, m), dtype=torch.float32, device=values.device)
    if b * m == 0:
        return out
    lib = load_library().lib
    rc = lib.ngm_batched_gather(values.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, _stream(values))
    _check(rc, "batched_gather")
    LAUNCHES["batched_gather"] += 1
    return out


KERNELS: Tuple[Tuple[str, str, str], ...] = (
    # (wrapper, source, TPU kernel it replaces)
    ("encode_fwd", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:707"),
    ("encode_bwd_table", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:785"),
    ("batched_gather", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:644"),
)
