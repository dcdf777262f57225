"""CUDA kernels of the permutohedral encoding, with their plain PyTorch versions.

Counterpart of ``neural_graph_mapping_tpu/ops/permuto_pallas.py`` for the
five Pallas kernels the port's paths reach:

=============================  ============================================
wrapper here                   replaces (JAX package)
=============================  ============================================
:func:`encode_fwd`             ``permuto_pallas.encode_fwd``
:func:`encode_bwd_table`       ``permuto_pallas.encode_bwd_table``
:func:`batched_gather`         ``permuto_pallas.batched_gather``
:func:`encode_fwd_moe`         ``permuto_pallas.encode_fwd_moe``
:func:`encode_fwd_moe_rays`    ``permuto_pallas.encode_fwd_moe_rays``
=============================  ============================================

The kernels live in ``csrc/permuto.cu``. They are compiled with ``nvcc`` for
sm_90a into ``_build/`` at first use (a plain C interface, bound with
ctypes; see :mod:`neural_graph_mapping_tpu_torch.ops.cuda_build`) and
launched on PyTorch's current stream. Each wrapper takes the plain version
only for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches (plain-version calls do not count), so a
run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from neural_graph_mapping_tpu_torch.ops import cuda_build, permuto

TILE = 1024  # pairs per MoE tile (permuto_pallas.TILE_M; kTile in permuto.cu)
# tiles per chunk of the plain MoE encodes: bounds their (tiles, L, 4, TILE)
# lattice tensors
_PLAIN_TILES = 64

LAUNCHES: Dict[str, int] = {
    "encode_fwd": 0, "encode_bwd_table": 0, "batched_gather": 0,
    "encode_fwd_moe": 0, "encode_fwd_moe_rays": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library() -> cuda_build.Library:
    """Build (once) and load ``csrc/permuto.cu``."""
    library = cuda_build.load("permuto")["permuto"]
    lib = library.lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    c_int_p, c_float_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    consts = [c_float_p, c_float_p, c_float_p, c_int_p]
    enc_args = [ptr, ptr, ptr, i32, i32, i32, i32, *consts, ptr]
    lib.ngm_encode_fwd.argtypes = enc_args
    lib.ngm_encode_bwd_table.argtypes = enc_args
    lib.ngm_batched_gather.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ngm_encode_fwd_moe.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, *consts, ptr]
    lib.ngm_encode_fwd_moe_rays.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32,
        *consts, ptr,
    ]
    for fn in (lib.ngm_encode_fwd, lib.ngm_encode_bwd_table, lib.ngm_batched_gather,
               lib.ngm_encode_fwd_moe, lib.ngm_encode_fwd_moe_rays):
        fn.restype = i32
    return library


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
    if cuda_build.route(table, coords) == "cpu":
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
        *consts, cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_fwd")
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
    if cuda_build.route(coords, g) == "cpu":
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
        *consts, cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_bwd_table")
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
    if cuda_build.route(values, idx) == "cpu":
        return batched_gather_plain(values, idx)
    b, n = values.shape
    m = idx.shape[1]
    out = torch.empty((b, m), dtype=torch.float32, device=values.device)
    if b * m == 0:
        return out
    lib = load_library().lib
    rc = lib.ngm_batched_gather(values.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, cuda_build.stream(values))
    cuda_build.check(rc, "batched_gather")
    LAUNCHES["batched_gather"] += 1
    return out


# -- encode_fwd_moe / encode_fwd_moe_rays (render path) ---------------------------


def _moe_check(tables, tile_experts, tiles: int, scales, t_size) -> Tuple[int, ...]:
    _check_f32("tables", tables)
    if tables.ndim != 4 or tables.shape[1] != 2:
        raise ValueError(f"tables must be (N, 2, L, T), got {tuple(tables.shape)}")
    n_levels, t = tables.shape[2], tables.shape[3]
    if len(scales) != n_levels:
        raise ValueError("scales do not match the tables' level count")
    caps = permuto.normalize_capacities(t_size, n_levels)
    if max(caps) > t:
        raise ValueError(f"level capacity {max(caps)} exceeds table size {t}")
    if tile_experts.shape != (tiles,) or tile_experts.dtype != torch.int32:
        raise TypeError(f"tile_experts must be ({tiles},) int32, got {tuple(tile_experts.shape)} {tile_experts.dtype}")
    return caps


def _num_live(num_live_tiles, tiles: int, device) -> torch.Tensor:
    """() int32 on ``device``; None = every tile is live. A tensor stays on
    the device (no host sync)."""
    if num_live_tiles is None:
        return torch.full((), tiles, dtype=torch.int32, device=device)
    return torch.as_tensor(num_live_tiles, dtype=torch.int32, device=device).reshape(())


def encode_fwd_moe_plain(
    tables, coords, tile_experts, scales, shifts, elev, t_size, num_live_tiles=None
) -> torch.Tensor:
    """Plain MoE encode: tables (N, 2, L, T), coords (tiles, 3, TILE)
    field-local, tile_experts (tiles,) -> (tiles, 2L, TILE). Gathers through
    flat indices ``e*2LT + f*LT + l*T + idx`` into the flattened tables (no
    per-tile table copy). Tiles at or past ``num_live_tiles`` are NaN, the
    kernel's "never written", so a consumer that masks by multiplication
    fails the tests."""
    n_levels, t = tables.shape[2], tables.shape[3]
    tiles, lanes = coords.shape[0], coords.shape[-1]
    s, sh, el = _const_tensors(scales, shifts, elev, coords.device)
    flat = tables.reshape(-1)
    level_base = torch.arange(n_levels, device=coords.device)[:, None, None] * t
    out = torch.empty((tiles, 2 * n_levels, lanes), dtype=torch.float32, device=coords.device)
    for a in range(0, tiles, _PLAIN_TILES):
        c = coords[a : a + _PLAIN_TILES]
        idx, w = permuto.lattice_keys_and_weights_soa(c.unbind(-2), s, sh, el, t_size)
        base = tile_experts[a : a + _PLAIN_TILES].long()[:, None, None, None] * (2 * n_levels * t)
        base = base + level_base + idx  # (c, L, 4, TILE) feature 0
        f0 = torch.sum(flat[base] * w, dim=-2)
        f1 = torch.sum(flat[base + n_levels * t] * w, dim=-2)
        out[a : a + c.shape[0]] = torch.stack([f0, f1], dim=2).reshape(c.shape[0], 2 * n_levels, lanes)
    if num_live_tiles is not None:
        live = torch.arange(tiles, device=coords.device) < num_live_tiles
        out = torch.where(live[:, None, None], out, torch.nan)
    return out


def encode_fwd_moe(
    tables, coords, tile_experts, scales, shifts, elev, t_size, num_live_tiles=None
) -> torch.Tensor:
    """Mixture-of-experts encode (permuto_pallas.encode_fwd_moe): every
    TILE-pair tile of ``coords`` (tiles, 3, TILE), field-local, is encoded
    against the (2, L, T) table of its field ``tile_experts[t]`` (int32) ->
    (tiles, 2L, TILE). Tiles at or past ``num_live_tiles`` (a () int32
    tensor, read by the kernel on the device) are never written."""
    tiles = coords.shape[0]
    if coords.shape != (tiles, 3, TILE):
        raise ValueError(f"coords must be (tiles, 3, {TILE}), got {tuple(coords.shape)}")
    _check_f32("coords", coords)
    caps = _moe_check(tables, tile_experts, tiles, scales, t_size)
    num_live = _num_live(num_live_tiles, tiles, coords.device)
    if cuda_build.route(tables, coords, tile_experts, num_live) == "cpu":
        return encode_fwd_moe_plain(tables, coords, tile_experts, scales, shifts, elev, caps, num_live)
    n_levels, t = tables.shape[2], tables.shape[3]
    out = torch.empty((tiles, 2 * n_levels, TILE), dtype=torch.float32, device=coords.device)
    if tiles == 0:
        return out
    lib = load_library().lib
    rc = lib.ngm_encode_fwd_moe(
        tables.data_ptr(), coords.data_ptr(), tile_experts.contiguous().data_ptr(),
        num_live.data_ptr(), out.data_ptr(), tiles, n_levels, t,
        *_lattice_consts(scales, shifts, elev, caps, n_levels), cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_fwd_moe")
    LAUNCHES["encode_fwd_moe"] += 1
    return out


def ray_local_coords(
    buf_orig, buf_dist, tile_experts, ray_params, field_poses, block_offset: int,
    log2_ks: int, width: int, coord_scale: float, coord_shift: float,
) -> torch.Tensor:
    """The ray kernel's point rebuild in plain PyTorch -> (tiles, 3, TILE)
    field-local coordinates; the same operations in the same order as
    ``encode_fwd_moe_rays_kernel`` (IEEE sqrt and reciprocal, no rsqrt)."""
    rp = ray_params
    pix = (buf_orig >> log2_ks).long() + block_offset
    iy_i = torch.div(pix, width, rounding_mode="floor")
    iy = iy_i.to(torch.float32)
    jx = (pix - iy_i * width).to(torch.float32)
    dx = (jx - rp[14]) * rp[12]
    dy = -(iy - rp[15]) * rp[13]
    inv_n = torch.reciprocal(torch.sqrt(dx * dx + dy * dy + 1.0))
    dwx = (rp[0] * dx + rp[1] * dy - rp[2]) * inv_n
    dwy = (rp[3] * dx + rp[4] * dy - rp[5]) * inv_n
    dwz = (rp[6] * dx + rp[7] * dy - rp[8]) * inv_n
    pose = field_poses[tile_experts.long()][:, :, None]  # (tiles, 7, 1)
    px = rp[9] + dwx * buf_dist - pose[:, 0]
    py = rp[10] + dwy * buf_dist - pose[:, 1]
    pz = rp[11] + dwz * buf_dist - pose[:, 2]
    qw, qx, qy, qz = pose[:, 3], -pose[:, 4], -pose[:, 5], -pose[:, 6]
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    xs = (px + qw * tx + (qy * tz - qz * ty)) * coord_scale + coord_shift
    ys = (py + qw * ty + (qz * tx - qx * tz)) * coord_scale + coord_shift
    zs = (pz + qw * tz + (qx * ty - qy * tx)) * coord_scale + coord_shift
    return torch.stack([xs, ys, zs], dim=1)


def encode_fwd_moe_rays_plain(
    tables, buf_orig, buf_dist, tile_experts, ray_params, field_poses, block_offset,
    scales, shifts, elev, t_size, log2_ks, width, coord_scale, coord_shift,
    num_live_tiles=None,
) -> torch.Tensor:
    """Plain ray-rebuilding MoE encode: :func:`ray_local_coords` then
    :func:`encode_fwd_moe_plain`."""
    coords = ray_local_coords(
        buf_orig, buf_dist, tile_experts, ray_params, field_poses, block_offset,
        log2_ks, width, coord_scale, coord_shift,
    )
    return encode_fwd_moe_plain(tables, coords, tile_experts, scales, shifts, elev, t_size, num_live_tiles)


def encode_fwd_moe_rays(
    tables, buf_orig, buf_dist, tile_experts, ray_params, field_poses, block_offset: int,
    scales, shifts, elev, t_size, log2_ks: int, width: int, coord_scale: float,
    coord_shift: float, num_live_tiles=None,
) -> torch.Tensor:
    """MoE encode that rebuilds each sample point from its pair index and
    span distance (permuto_pallas.encode_fwd_moe_rays).

    tables (N, 2, L, T); buf_orig (tiles, TILE) int32 k-MINOR pair indices
    (ray = index >> log2_ks); buf_dist (tiles, TILE) f32 span distances;
    tile_experts (tiles,) int32; ray_params (16,) f32: R row-major, origin,
    1/fx, 1/fy, cx, cy (pixel centre 0); field_poses (N, 7) position + wxyz
    quaternion; block_offset: pixel index of the block's first ray (render
    blocks are row-major); width: image width. -> (tiles, 2L, TILE); tiles
    at or past ``num_live_tiles`` are never written.
    """
    tiles = buf_orig.shape[0]
    if buf_orig.shape != (tiles, TILE) or buf_orig.dtype != torch.int32 or not buf_orig.is_contiguous():
        raise TypeError(f"buf_orig must be contiguous (tiles, {TILE}) int32")
    if buf_dist.shape != (tiles, TILE):
        raise ValueError(f"buf_dist must be (tiles, {TILE}), got {tuple(buf_dist.shape)}")
    _check_f32("buf_dist", buf_dist)
    _check_f32("ray_params", ray_params)
    _check_f32("field_poses", field_poses)
    if ray_params.shape != (16,) or field_poses.shape != (tables.shape[0], 7):
        raise ValueError(f"ray_params {tuple(ray_params.shape)} / field_poses {tuple(field_poses.shape)}")
    if not (0 <= int(log2_ks) <= 30 and int(width) >= 1):
        raise ValueError(f"log2_ks {log2_ks} / width {width}")
    caps = _moe_check(tables, tile_experts, tiles, scales, t_size)
    num_live = _num_live(num_live_tiles, tiles, buf_dist.device)
    if cuda_build.route(tables, buf_orig, buf_dist, tile_experts, ray_params, field_poses, num_live) == "cpu":
        return encode_fwd_moe_rays_plain(
            tables, buf_orig, buf_dist, tile_experts, ray_params, field_poses, int(block_offset),
            scales, shifts, elev, caps, int(log2_ks), int(width), coord_scale, coord_shift, num_live,
        )
    n_levels, t = tables.shape[2], tables.shape[3]
    out = torch.empty((tiles, 2 * n_levels, TILE), dtype=torch.float32, device=buf_dist.device)
    if tiles == 0:
        return out
    lib = load_library().lib
    rc = lib.ngm_encode_fwd_moe_rays(
        tables.data_ptr(), buf_orig.data_ptr(), buf_dist.data_ptr(),
        tile_experts.contiguous().data_ptr(), num_live.data_ptr(), ray_params.data_ptr(),
        field_poses.data_ptr(), out.data_ptr(), tiles, n_levels, t, int(block_offset),
        int(log2_ks), int(width), float(coord_scale), float(coord_shift),
        *_lattice_consts(scales, shifts, elev, caps, n_levels), cuda_build.stream(buf_dist),
    )
    cuda_build.check(rc, "encode_fwd_moe_rays")
    LAUNCHES["encode_fwd_moe_rays"] += 1
    return out


KERNELS: Tuple[Tuple[str, str, str], ...] = (
    # (wrapper, source, TPU kernel it replaces)
    ("encode_fwd", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:707"),
    ("encode_bwd_table", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:785"),
    ("batched_gather", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:644"),
    ("encode_fwd_moe_rays", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:522"),
    ("encode_fwd_moe", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:353"),
)
