"""Top-2 nearest valid field centres per point: the CUDA kernel of the render
dispatch and its plain PyTorch version (counterpart of
``neural_graph_mapping_tpu/ops/topk_pallas.py``).

``topk2_fields`` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches ``csrc/topk.cu`` (built at first use, see
:mod:`neural_graph_mapping_tpu_torch.ops.cuda_build`) or raises. Both use
the direct form (p - c)^2 with every operation rounded on its own, so they
agree bit for bit; the JAX kernel's |c|^2 - 2 c.p scores agree with them to
rounding (1e-4 m in the tests). ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from neural_graph_mapping_tpu_torch.ops import cuda_build

LAUNCHES: Dict[str, int] = {"topk2_fields": 0}

KERNELS: Tuple[Tuple[str, str, str], ...] = (
    # (wrapper, source, TPU kernel it replaces)
    ("topk2_fields", "neural_graph_mapping_tpu_torch/csrc/topk.cu",
     "neural_graph_mapping_tpu/ops/topk_pallas.py:97"),
)

# points per chunk of the plain version: bounds its (chunk, N) distance matrix
_PLAIN_CHUNK = 1 << 20


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIBRARY: Optional[cuda_build.Library] = None


def load_library() -> cuda_build.Library:
    """Build (once) and load ``csrc/topk.cu``; the first call sets the
    function's ctypes signature, later calls return the cached library."""
    global _LIBRARY
    if _LIBRARY is None:
        library = cuda_build.load("topk")["topk"]
        ptr = ctypes.c_void_p
        library.lib.ngm_topk2_fields.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
        library.lib.ngm_topk2_fields.restype = ctypes.c_int
        _LIBRARY = library
    return _LIBRARY


def topk2_fields_plain(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Plain top-2: points (3, P), centres (N, 3), valid (N,) bool ->
    (dists (2, P) f32, idx (2, P) int32). A stable sort of the masked
    squared distances gives the lexicographic (distance, index) order."""
    n = centers.shape[0]
    d_parts, i_parts = [], []
    for s in range(0, points_fm.shape[1], _PLAIN_CHUNK):
        pts = points_fm[:, s : s + _PLAIN_CHUNK]
        dx = pts[0][:, None] - centers[:, 0][None, :]
        dy = pts[1][:, None] - centers[:, 1][None, :]
        dz = pts[2][:, None] - centers[:, 2][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(valid[None, :], d2, torch.inf)
        if n < 2:  # fewer centres than neighbours: pad with inf (index clamped)
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], 2 - n), torch.inf)], dim=1)
        vals, idx = torch.sort(d2, dim=1, stable=True)
        d_parts.append(torch.sqrt(vals[:, :2]).T)
        i_parts.append(torch.clamp(idx[:, :2], max=n - 1).T.to(torch.int32))
    if not d_parts:
        return points_fm.new_empty((2, 0)), torch.empty((2, 0), dtype=torch.int32, device=points_fm.device)
    return torch.cat(d_parts, dim=1).contiguous(), torch.cat(i_parts, dim=1).contiguous()


def topk2_fields(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Two nearest valid field centres per point (topk_pallas.topk2_fields):
    points (3, P) f32, centres (N, 3) f32, valid (N,) bool -> (dists (2, P)
    f32, +inf for an invalid winner; idx (2, P) int32, ties to the lower
    index, clamped to N - 1)."""
    if points_fm.ndim != 2 or points_fm.shape[0] != 3:
        raise ValueError(f"points must be (3, P), got {tuple(points_fm.shape)}")
    if centers.ndim != 2 or centers.shape[1] != 3 or valid.shape != (centers.shape[0],):
        raise ValueError(f"centres {tuple(centers.shape)} / valid {tuple(valid.shape)}")
    if points_fm.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("points and centres must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    n, p = centers.shape[0], points_fm.shape[1]
    if n < 1:
        raise ValueError("topk2_fields needs at least one centre")
    if cuda_build.route(points_fm, centers, valid) == "cpu":
        return topk2_fields_plain(points_fm, centers, valid)
    pts = points_fm.contiguous()
    cen = torch.cat([centers, valid.to(torch.float32)[:, None]], dim=1).contiguous()
    out_d = torch.empty((2, p), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((2, p), dtype=torch.int32, device=pts.device)
    if p == 0:
        return out_d, out_i
    rc = load_library().lib.ngm_topk2_fields(
        pts.data_ptr(), cen.data_ptr(), n, p, out_d.data_ptr(), out_i.data_ptr(), cuda_build.stream(pts)
    )
    cuda_build.check(rc, "topk2_fields")
    LAUNCHES["topk2_fields"] += 1
    return out_d, out_i
