"""Top-2 nearest valid field centres per point: the CUDA kernel of the render
dispatch and its plain PyTorch version (counterpart of
``neural_graph_mapping_tpu/ops/topk_pallas.py``).

``topk2_fields`` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches ``csrc/topk.cu`` (built at first use, see
:mod:`neural_graph_mapping_tpu_torch.ops.cuda_build`) or raises. Both use
the direct form (p - c)^2 with every operation rounded on its own, so they
agree bit for bit; the JAX kernel's |c|^2 - 2 c.p scores agree with them to
rounding (1e-4 m in the tests). ``LAUNCHES`` counts kernel launches only.

The kernel takes the centres with validity folded in (:func:`fold_validity`)
and drops, for each box of ``BOX_POINTS`` consecutive points (a warp's),
the centres that cannot be any of its points' two nearest. This module
holds that rule's constants, passed to the kernel at every launch, and its
plain model :func:`topk2_survivors_plain`; :func:`topk2_box_survivors`
asks the kernel how many centres each box kept. Tests and ``chip_smoke.py``
use those two; the port's path does not.
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

# entries of the plain version's (points, N) distance matrix at once: its
# points go in chunks of this many over N (256 MB an f32 temporary)
_PLAIN_ENTRIES = 1 << 26
# consecutive points that share a box in the kernel (a warp's, csrc/topk.cu,
# which refuses a launch that names another), and the pruning test's
# relative margins as float32 factors; both go to the kernel with each launch
BOX_POINTS = 64
PRUNE_LOW, PRUNE_HIGH = 0.99999, 1.00001


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
        num, real = ctypes.c_int, ctypes.c_float
        library.lib.ngm_topk2_fields.argtypes = [ptr, ptr, num, num, num, real, real, ptr, ptr, ptr, ptr]
        library.lib.ngm_topk2_fields.restype = ctypes.c_int
        _LIBRARY = library
    return _LIBRARY


def topk2_fields_plain(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Plain top-2: points (3, P) finite, centres (N, 3), valid (N,) bool ->
    (dists (2, P) f32, idx (2, P) int32): each point's two smallest masked
    squared distances in lexicographic (distance, index) order, the order a
    stable sort gives them. ``argmin`` takes the first of equal minima;
    the first's entry set to +inf, a second ``argmin`` takes the next, and
    where that is +inf every other entry is, so the second is the lowest
    index but the first's. Points go in chunks of ``_PLAIN_ENTRIES``
    matrix entries, so many centres take no more memory than a few."""
    n = centers.shape[0]
    rows = max(1024, _PLAIN_ENTRIES // max(n, 2))
    d_parts, i_parts = [], []
    for s in range(0, points_fm.shape[1], rows):
        pts = points_fm[:, s : s + rows]
        d2 = pts[0][:, None] - centers[:, 0][None, :]
        dy = pts[1][:, None] - centers[:, 1][None, :]
        dz = pts[2][:, None] - centers[:, 2][None, :]
        d2.mul_(d2).add_(dy.mul_(dy)).add_(dz.mul_(dz))  # dx * dx + dy * dy + dz * dz
        del dy, dz
        d2.masked_fill_(~valid[None, :], torch.inf)
        if n < 2:  # fewer centres than neighbours: pad with inf (index clamped)
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], 2 - n), torch.inf)], dim=1)
        first = torch.argmin(d2, dim=1, keepdim=True)
        d_first = torch.gather(d2, 1, first)
        d2.scatter_(1, first, torch.inf)
        second = torch.argmin(d2, dim=1, keepdim=True)
        d_second = torch.gather(d2, 1, second)
        second = torch.where(torch.isinf(d_second), (first == 0).long(), second)
        d_parts.append(torch.sqrt(torch.cat([d_first, d_second], dim=1)).T)
        i_parts.append(torch.clamp(torch.cat([first, second], dim=1), max=n - 1).T.to(torch.int32))
    if not d_parts:
        return points_fm.new_empty((2, 0)), torch.empty((2, 0), dtype=torch.int32, device=points_fm.device)
    return torch.cat(d_parts, dim=1).contiguous(), torch.cat(i_parts, dim=1).contiguous()


def fold_validity(centers: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 3) centres and (N,) valid -> the kernel's (N, 4) f32 centres:
    x, y, z, 0, with x = +inf where the centre is invalid, so that its
    squared distance to any finite point is +inf exactly, as the plain
    version's mask gives it."""
    x = torch.where(valid, centers[:, 0], torch.inf)
    return torch.stack([x, centers[:, 1], centers[:, 2], torch.zeros_like(x)], dim=1).contiguous()


def topk2_survivors_plain(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor,
                          box_points: int = BOX_POINTS) -> torch.Tensor:
    """The kernel's pruning rule in plain PyTorch, in its order of operations:
    points (3, P), centres (N, 3), valid (N,) -> (boxes, N) bool, True where
    a centre survives for the box of ``box_points`` consecutive points.

    With lo, hi a box's bounds, lb and ub are the squared distances
    from a centre to the nearest and the farthest point of the box; U is the
    second-smallest ub over the centres (+inf below two centres), and a
    centre is dropped where lb * PRUNE_LOW > U * PRUNE_HIGH. Invalid centres
    enter at x = +inf (:func:`fold_validity`)."""
    f32 = torch.float32
    cen = fold_validity(centers, valid)[:, :3].T[:, None, :]  # (3, 1, N)
    p = points_fm.shape[1]
    boxes = -(-p // box_points)
    pad = boxes * box_points - p
    lo = torch.nn.functional.pad(points_fm, (0, pad), value=torch.inf).reshape(3, boxes, box_points)
    hi = torch.nn.functional.pad(points_fm, (0, pad), value=-torch.inf).reshape(3, boxes, box_points)
    lo = lo.amin(dim=-1)[:, :, None]  # (3, boxes, 1)
    hi = hi.amax(dim=-1)[:, :, None]
    g = torch.clamp(torch.maximum(lo - cen, cen - hi), min=0.0)
    f = torch.maximum(cen - lo, hi - cen)
    lb = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]  # (boxes, N)
    ub = f[0] * f[0] + f[1] * f[1] + f[2] * f[2]
    if ub.shape[1] >= 2:
        u = torch.topk(ub, 2, dim=1, largest=False).values[:, 1:]
    else:
        u = torch.full((boxes, 1), torch.inf, dtype=f32, device=ub.device)
    low = torch.tensor(PRUNE_LOW, dtype=f32, device=ub.device)
    high = torch.tensor(PRUNE_HIGH, dtype=f32, device=ub.device)
    return ~(lb * low > u * high)


def _check_inputs(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor) -> None:
    if points_fm.ndim != 2 or points_fm.shape[0] != 3:
        raise ValueError(f"points must be (3, P), got {tuple(points_fm.shape)}")
    if centers.ndim != 2 or centers.shape[1] != 3 or valid.shape != (centers.shape[0],):
        raise ValueError(f"centres {tuple(centers.shape)} / valid {tuple(valid.shape)}")
    if points_fm.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("points and centres must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if centers.shape[0] < 1:
        raise ValueError("topk2_fields needs at least one centre")


def _launch(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor,
            box_survivors: Optional[torch.Tensor] = None):
    """One launch of the kernel on CUDA tensors (P >= 1): (dists, idx), and
    each box's surviving centres written into ``box_survivors`` if given."""
    pts = points_fm.contiguous()
    cen = fold_validity(centers, valid)
    p = pts.shape[1]
    out_d = torch.empty((2, p), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((2, p), dtype=torch.int32, device=pts.device)
    rc = load_library().lib.ngm_topk2_fields(
        pts.data_ptr(), cen.data_ptr(), cen.shape[0], p, BOX_POINTS, PRUNE_LOW, PRUNE_HIGH,
        out_d.data_ptr(), out_i.data_ptr(), None if box_survivors is None else box_survivors.data_ptr(),
        cuda_build.stream(pts),
    )
    cuda_build.check(rc, "topk2_fields")
    return out_d, out_i


def topk2_fields(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor):
    """Two nearest valid field centres per point (topk_pallas.topk2_fields):
    points (3, P) f32, centres (N, 3) f32, valid (N,) bool -> (dists (2, P)
    f32, +inf for an invalid winner; idx (2, P) int32, ties to the lower
    index, clamped to N - 1)."""
    _check_inputs(points_fm, centers, valid)
    if cuda_build.route(points_fm, centers, valid) == "cpu":
        return topk2_fields_plain(points_fm, centers, valid)
    p = points_fm.shape[1]
    if p == 0:
        return (torch.empty((2, 0), dtype=torch.float32, device=points_fm.device),
                torch.empty((2, 0), dtype=torch.int32, device=points_fm.device))
    out = _launch(points_fm, centers, valid)
    LAUNCHES["topk2_fields"] += 1
    return out


def topk2_box_survivors(points_fm: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """How many centres the kernel's pruning kept for each box of
    ``BOX_POINTS`` consecutive points: (ceil(P / BOX_POINTS),) int32, read
    from the kernel itself on CUDA tensors (the same kernel, instantiated to
    count, in a launch of its own that ``LAUNCHES`` does not count), from
    :func:`topk2_survivors_plain` on CPU tensors. A measurement, for tests
    and ``chip_smoke.py``: the pairs the kernel evaluated are these counts
    times each box's points."""
    _check_inputs(points_fm, centers, valid)
    if cuda_build.route(points_fm, centers, valid) == "cpu":
        return topk2_survivors_plain(points_fm, centers, valid).sum(1, dtype=torch.int32)
    boxes = -(-points_fm.shape[1] // BOX_POINTS)
    counts = torch.empty((boxes,), dtype=torch.int32, device=points_fm.device)
    if boxes:
        _launch(points_fm, centers, valid, counts)
    return counts
