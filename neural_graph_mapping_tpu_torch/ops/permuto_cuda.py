"""CUDA kernels of the permutohedral encoding, with their plain PyTorch versions.

Counterpart of ``neural_graph_mapping_tpu/ops/permuto_pallas.py`` for its
nine Pallas kernels:

=============================  ============================================
wrapper here                   replaces (JAX package)
=============================  ============================================
:func:`encode_fwd`             ``permuto_pallas.encode_fwd``
:func:`encode_bwd_table`       ``permuto_pallas.encode_bwd_table``
:func:`batched_gather`         ``permuto_pallas.batched_gather``
:func:`encode_fwd_moe`         ``permuto_pallas.encode_fwd_moe``
:func:`encode_fwd_moe_rays`    ``permuto_pallas.encode_fwd_moe_rays``
:func:`gather_pairs`           ``permuto_pallas.gather_pairs``
:func:`table_grad`             ``permuto_pallas.table_grad``
:func:`encode_mlp_fwd`         ``permuto_pallas.encode_mlp_fwd``
:func:`encode_mlp_bwd`         ``permuto_pallas.encode_mlp_bwd``
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
    "encode_fwd_moe": 0, "encode_fwd_moe_rays": 0, "gather_pairs": 0, "table_grad": 0,
    "encode_mlp_fwd": 0, "encode_mlp_bwd": 0,
}
# widest field MLP the fused kernels take (kMlpMax* in permuto.cu): 16 levels
# (D = 32 features), 32 hidden units, 4 outputs
MLP_MAX_LEVELS, MLP_MAX_HIDDEN, MLP_MAX_OUT = 16, 32, 4


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIBRARY: Optional[cuda_build.Library] = None


def load_library() -> cuda_build.Library:
    """Build (once) and load ``csrc/permuto.cu``. The first call sets the
    functions' ctypes signatures and runs ``ngm_permuto_init``; later calls
    return the bound library from the cache."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    library = cuda_build.load("permuto")["permuto"]
    lib = library.lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    c_int_p, c_float_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    consts = [c_float_p, c_float_p, c_float_p, c_int_p]
    enc_args = [ptr, ptr, ptr, i32, i32, i32, i32, *consts, ptr]
    lib.ngm_permuto_init.argtypes = []
    lib.ngm_encode_fwd.argtypes = enc_args
    lib.ngm_encode_bwd_table_plan.argtypes = [i32, i32, i32, i32]
    lib.ngm_encode_bwd_table.argtypes = enc_args
    lib.ngm_batched_gather.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ngm_encode_fwd_moe.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, *consts, ptr]
    lib.ngm_encode_fwd_moe_rays.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32,
        *consts, ptr,
    ]
    lib.ngm_gather_pairs_staged.argtypes = [ptr, i32, i32]
    lib.ngm_gather_pairs.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ngm_table_grad_plan.argtypes = [i32, i32, i32]
    lib.ngm_table_grad.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ngm_encode_mlp_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [*consts, ptr]
    lib.ngm_encode_mlp_bwd.argtypes = [ptr] * 11 + [i32] * 6 + [*consts, ptr]
    for fn in (lib.ngm_permuto_init, lib.ngm_encode_fwd, lib.ngm_encode_bwd_table_plan,
               lib.ngm_encode_bwd_table, lib.ngm_batched_gather, lib.ngm_encode_fwd_moe,
               lib.ngm_encode_fwd_moe_rays, lib.ngm_gather_pairs_staged, lib.ngm_gather_pairs,
               lib.ngm_table_grad_plan, lib.ngm_table_grad, lib.ngm_encode_mlp_fwd,
               lib.ngm_encode_mlp_bwd):
        fn.restype = i32
    cuda_build.check(lib.ngm_permuto_init(), "permuto init")
    _LIBRARY = library
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


# The designs of the two histogram kernels (encode_bwd_table, table_grad),
# by the plan their C entry points return for a shape: global atomics into a
# zeroed output; one staged block a row, which writes every entry; staged
# rows split over blocks, which add into a zeroed output.
HIST_VARIANTS = ("direct", "staged", "staged, split rows")


def _hist_output(plan: int, shape, device) -> torch.Tensor:
    """A histogram kernel's output: uninitialised where one block writes
    every entry of its row, zeroed where the kernel adds into it."""
    if HIST_VARIANTS[plan] == "staged":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.zeros(shape, dtype=torch.float32, device=device)


# -- encode_fwd -----------------------------------------------------------------


def encode_fwd_plain(table, coords, scales, shifts, elev, t_size) -> torch.Tensor:
    """Plain PyTorch encode: table (..., 2, L, T), coords (..., 3, P) -> (..., 2L, P)."""
    s, sh, el = _const_tensors(scales, shifts, elev, coords.device)
    idx, w = permuto.lattice_keys_and_weights_soa(coords.unbind(-2), s, sh, el, t_size)
    return permuto.gather_blend_plain(table, idx, w)


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
    shape = lead + (2, n_levels, t)
    if b * p == 0:
        return torch.zeros(shape, dtype=torch.float32, device=coords.device)
    consts = _lattice_consts(scales, shifts, elev, caps, n_levels)
    lib = load_library().lib
    grad = _hist_output(lib.ngm_encode_bwd_table_plan(b, n_levels, p, t), shape, coords.device)
    rc = lib.ngm_encode_bwd_table(
        coords.data_ptr(), g.data_ptr(), grad.data_ptr(), b, p, n_levels, t,
        *consts, cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_bwd_table")
    LAUNCHES["encode_bwd_table"] += 1
    return grad


def encode_bwd_table_variant(coords, scales, t_size) -> str:
    """The design :func:`encode_bwd_table` takes for CUDA ``coords``
    (..., 3, P), one of :data:`HIST_VARIANTS` (the C entry point chooses by
    shape; ``csrc/permuto.cu``)."""
    n_levels = len(scales)
    t = max(permuto.normalize_capacities(t_size, n_levels))
    b = int(torch.Size(coords.shape[:-2]).numel())
    return HIST_VARIANTS[load_library().lib.ngm_encode_bwd_table_plan(b, n_levels, coords.shape[-1], t)]


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


# -- gather_pairs / table_grad (the gather route of gather_blend) -------------


def _rows_check(idx: torch.Tensor, lead) -> None:
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise TypeError("idx must be contiguous int64")
    if idx.shape[:-1] != lead:
        raise ValueError(f"idx leading dims {tuple(idx.shape[:-1])} differ from {tuple(lead)}")


def _features_check(n_features: int) -> None:
    if n_features != 2:
        raise ValueError(f"the gather-route kernels take 2 features per level, got {n_features}")


def gather_pairs_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats[..., f, m] = table[..., f, idx[..., m]]."""
    f = table.shape[-2]
    return torch.gather(table, -1, idx.unsqueeze(-2).expand(idx.shape[:-1] + (f, idx.shape[-1])))


def gather_pairs(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched hash-table lookup (permuto_pallas.gather_pairs): table
    (..., 2, T) f32, idx (..., M) int64 in [0, T) -> (..., 2, M), exact."""
    _check_f32("table", table)
    _rows_check(idx, table.shape[:-2])
    if cuda_build.route(table, idx) == "cpu":
        return gather_pairs_plain(table, idx)
    _features_check(table.shape[-2])
    t, m = table.shape[-1], idx.shape[-1]
    rows = int(torch.Size(idx.shape[:-1]).numel())
    out = torch.empty(idx.shape[:-1] + (2, m), dtype=torch.float32, device=table.device)
    if rows * m == 0:
        return out
    lib = load_library().lib
    rc = lib.ngm_gather_pairs(table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, t, m,
                              cuda_build.stream(table))
    cuda_build.check(rc, "gather_pairs")
    LAUNCHES["gather_pairs"] += 1
    return out


def gather_pairs_variant(table: torch.Tensor, idx: torch.Tensor) -> str:
    """'staged' or 'direct': the design the kernel takes for these CUDA
    tensors (the C entry point chooses by shape; ``csrc/permuto.cu``)."""
    staged = load_library().lib.ngm_gather_pairs_staged(table.data_ptr(), table.shape[-1], idx.shape[-1])
    return "staged" if staged else "direct"


def table_grad_plain(idx: torch.Tensor, gvals: torch.Tensor, table_size: int) -> torch.Tensor:
    """Scatter-add of gvals (..., F, M) at idx (..., M) into (..., F, T),
    by one ``index_add_`` over the flattened tables."""
    return permuto._table_grad_fallback(idx, gvals, table_size)


def table_grad(idx: torch.Tensor, gvals: torch.Tensor, table_size: int) -> torch.Tensor:
    """Histogram of per-pair gradients into feature-major tables
    (permuto_pallas.table_grad): idx (..., M) int64 in [0, table_size),
    gvals (..., 2, M) f32 -> (..., 2, table_size)."""
    _check_f32("gvals", gvals)
    _rows_check(idx, gvals.shape[:-2])
    if gvals.shape[-1] != idx.shape[-1]:
        raise ValueError(f"shapes idx {tuple(idx.shape)} / gvals {tuple(gvals.shape)}")
    if cuda_build.route(idx, gvals) == "cpu":
        return table_grad_plain(idx, gvals, table_size)
    _features_check(gvals.shape[-2])
    m = idx.shape[-1]
    rows = int(torch.Size(idx.shape[:-1]).numel())
    shape = idx.shape[:-1] + (2, table_size)
    if rows * m == 0:
        return torch.zeros(shape, dtype=torch.float32, device=idx.device)
    lib = load_library().lib
    grad = _hist_output(lib.ngm_table_grad_plan(rows, int(table_size), m), shape, idx.device)
    rc = lib.ngm_table_grad(idx.data_ptr(), gvals.data_ptr(), grad.data_ptr(), rows,
                            int(table_size), m, cuda_build.stream(idx))
    cuda_build.check(rc, "table_grad")
    LAUNCHES["table_grad"] += 1
    return grad


def table_grad_variant(idx: torch.Tensor, gvals: torch.Tensor, table_size: int) -> str:
    """The design :func:`table_grad` takes for these CUDA tensors, one of
    :data:`HIST_VARIANTS` (the C entry point chooses by shape;
    ``csrc/permuto.cu``)."""
    rows = int(torch.Size(idx.shape[:-1]).numel())
    return HIST_VARIANTS[load_library().lib.ngm_table_grad_plan(rows, int(table_size), idx.shape[-1])]


# -- encode_mlp_fwd / encode_mlp_bwd (the fused training route) ---------------


def _mlp_check(lead, n_levels: int, w0, b0, w1) -> Tuple[int, int]:
    """Shapes of the field MLP's weights -> (hidden, outputs)."""
    h, o = w0.shape[-1], w1.shape[-1]
    want = {"w0": lead + (2 * n_levels, h), "b0": lead + (h,), "w1": lead + (h, o)}
    for name, t in (("w0", w0), ("b0", b0), ("w1", w1)):
        _check_f32(name, t)
        if t.shape != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    return h, o


def _mlp_widths_check(n_levels: int, h: int, o: int) -> None:
    if n_levels > MLP_MAX_LEVELS or h > MLP_MAX_HIDDEN or o > MLP_MAX_OUT:
        raise ValueError(
            f"the fused encode+MLP kernels take at most {MLP_MAX_LEVELS} levels, "
            f"{MLP_MAX_HIDDEN} hidden units and {MLP_MAX_OUT} outputs; got {n_levels}, {h}, {o}"
        )


def mlp_plain(feats, w0, b0, w1, b1) -> torch.Tensor:
    """The field MLP on feature-major (..., D, P) features -> (..., O, P)."""
    h = torch.relu(torch.matmul(w0.transpose(-1, -2), feats) + b0[..., None])
    return torch.matmul(w1.transpose(-1, -2), h) + b1[..., None]


def encode_mlp_fwd_plain(
    table, w0, b0, w1, b1, coords, scales, shifts, elev, t_size
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fused forward: :func:`encode_fwd_plain` then the MLP ->
    (out (..., O, P), feats (..., 2L, P))."""
    feats = encode_fwd_plain(table, coords, scales, shifts, elev, t_size)
    return mlp_plain(feats, w0, b0, w1, b1), feats


def encode_mlp_fwd(
    table, w0, b0, w1, b1, coords, scales, shifts, elev, t_size
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused encode + one-hidden-layer ReLU MLP (permuto_pallas.encode_mlp_fwd).

    table (..., 2, L, T), w0 (..., 2L, H), b0 (..., H), w1 (..., H, O),
    b1 (..., O), coords (..., 3, P) -> (out (..., O, P), feats (..., 2L, P));
    ``feats`` is the backward's residual in the canonical feature-major
    layout."""
    lead = coords.shape[:-2]
    if coords.shape[-2] != 3 or table.shape[:-3] != lead or table.shape[-3] != 2:
        raise ValueError(f"shapes table {tuple(table.shape)} / coords {tuple(coords.shape)}")
    _check_f32("table", table)
    _check_f32("coords", coords)
    n_levels, t = table.shape[-2], table.shape[-1]
    h, o = _mlp_check(lead, n_levels, w0, b0, w1)
    _check_f32("b1", b1)
    if b1.shape != lead + (o,):
        raise ValueError(f"b1 has shape {tuple(b1.shape)}, expected {lead + (o,)}")
    caps = permuto.normalize_capacities(t_size, n_levels)
    if max(caps) > t:
        raise ValueError(f"level capacity {max(caps)} exceeds table size {t}")
    if cuda_build.route(table, coords, w0, b0, w1, b1) == "cpu":
        return encode_mlp_fwd_plain(table, w0, b0, w1, b1, coords, scales, shifts, elev, caps)
    _mlp_widths_check(n_levels, h, o)
    p = coords.shape[-1]
    b = int(torch.Size(lead).numel())
    out = torch.empty(lead + (o, p), dtype=torch.float32, device=coords.device)
    feats = torch.empty(lead + (2 * n_levels, p), dtype=torch.float32, device=coords.device)
    if b * p == 0:
        return out, feats
    lib = load_library().lib
    rc = lib.ngm_encode_mlp_fwd(
        table.data_ptr(), coords.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), out.data_ptr(), feats.data_ptr(), b, p, n_levels, t, h, o,
        *_lattice_consts(scales, shifts, elev, caps, n_levels), cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_mlp_fwd")
    LAUNCHES["encode_mlp_fwd"] += 1
    return out, feats


def encode_mlp_bwd_plain(coords, feats, g, w0, b0, w1, scales, shifts, elev, t_size):
    """Plain fused backward: autograd of the plain MLP on the residual, then
    :func:`encode_bwd_table_plain` of dL/dfeatures -> (grad_table, dw0, db0,
    dw1, db1)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (feats, w0, b0, w1)]
        b1 = torch.zeros(w1.shape[:-2] + w1.shape[-1:], dtype=g.dtype, device=g.device,
                         requires_grad=True)
        out = mlp_plain(*leaves, b1)
        dfeats, dw0, db0, dw1, db1 = torch.autograd.grad(out, leaves + [b1], g)
    caps = permuto.normalize_capacities(t_size, len(scales))
    grad_table = encode_bwd_table_plain(coords, dfeats, scales, shifts, elev, caps, max(caps))
    return grad_table, dw0, db0, dw1, db1


def encode_mlp_bwd(coords, feats, g, w0, b0, w1, scales, shifts, elev, t_size):
    """Backward of :func:`encode_mlp_fwd` (permuto_pallas.encode_mlp_bwd):
    coords (..., 3, P), the residual feats (..., 2L, P), the head cotangent
    g (..., O, P) and the weights -> (grad_table (..., 2, L, T), dw0, db0,
    dw1, db1), T = max(t_size). The bias b1 does not enter the backward."""
    lead = coords.shape[:-2]
    n_levels = len(scales)
    p = coords.shape[-1]
    if coords.shape[-2] != 3 or feats.shape != lead + (2 * n_levels, p):
        raise ValueError(f"shapes coords {tuple(coords.shape)} / feats {tuple(feats.shape)}")
    _check_f32("coords", coords)
    _check_f32("feats", feats)
    h, o = _mlp_check(lead, n_levels, w0, b0, w1)
    _check_f32("g", g)
    if g.shape != lead + (o, p):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {lead + (o, p)}")
    caps = permuto.normalize_capacities(t_size, n_levels)
    t = max(caps)
    if cuda_build.route(coords, feats, g, w0, b0, w1) == "cpu":
        return encode_mlp_bwd_plain(coords, feats, g, w0, b0, w1, scales, shifts, elev, caps)
    _mlp_widths_check(n_levels, h, o)
    b = int(torch.Size(lead).numel())
    d = 2 * n_levels
    grad_table = torch.zeros(lead + (2, n_levels, t), dtype=torch.float32, device=coords.device)
    # the four weight gradients as views of one zeroed buffer: one memset
    flat = torch.zeros(b * (d * h + h + h * o + o), dtype=torch.float32, device=coords.device)
    dw0, db0, dw1, db1 = (
        part.view(lead + shape)
        for part, shape in zip(flat.split([b * d * h, b * h, b * h * o, b * o]),
                               ((d, h), (h,), (h, o), (o,)))
    )
    if b * p == 0:
        return grad_table, dw0, db0, dw1, db1
    lib = load_library().lib
    rc = lib.ngm_encode_mlp_bwd(
        coords.data_ptr(), feats.data_ptr(), g.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w1.data_ptr(), grad_table.data_ptr(), dw0.data_ptr(), db0.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), b, p, n_levels, t, h, o,
        *_lattice_consts(scales, shifts, elev, caps, n_levels), cuda_build.stream(coords),
    )
    cuda_build.check(rc, "encode_mlp_bwd")
    LAUNCHES["encode_mlp_bwd"] += 1
    return grad_table, dw0, db0, dw1, db1


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
    ("gather_pairs", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:878"),
    ("table_grad", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:961"),
    ("encode_mlp_fwd", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:1197"),
    ("encode_mlp_bwd", "neural_graph_mapping_tpu_torch/csrc/permuto.cu",
     "neural_graph_mapping_tpu/ops/permuto_pallas.py:1303"),
)
