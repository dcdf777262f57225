"""Permutohedral-lattice hash encoding core (port of
neural_graph_mapping_tpu.ops.permuto).

Points-minor layout throughout: per-level tensors are (..., L, d+1, P) and
hash tables are feature-major (F, L, T), exactly as in the JAX package, so
tables, indices and outputs compare element for element.

- :func:`lattice_keys_and_weights_soa` plus :func:`gather_blend` is the
  gather route: the lattice is plain PyTorch, differentiable in the points
  (point gradients flow through the weights), and ``gather_blend`` is an
  autograd function whose lookup and table gradient are the
  ``gather_pairs`` / ``table_grad`` kernels of
  :mod:`neural_graph_mapping_tpu_torch.ops.permuto_cuda`.
  :func:`gather_blend_plain` is the same blend by plain autograd.
- :func:`encode_fused` is the training encode: forward and table gradient
  are the ``encode_fwd`` / ``encode_bwd_table`` kernels, and, like the JAX
  ``encode_fused``, it returns a ZERO coordinate gradient.
- :func:`encode_mlp_fused` is the fused training route of the production
  field (encode + one-hidden-layer MLP): ``encode_mlp_fwd`` /
  ``encode_mlp_bwd``, also with a zero coordinate gradient.

uint32 hashing is emulated in int64 masked to 32 bits; the products are
split into 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# Large primes for spatial hashing (instant-ngp style).
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)

_U32 = 0xFFFFFFFF


def make_elevation_scale(d: int) -> np.ndarray:
    """Column normalization of the elevation basis E (times d+1 so the
    effective lattice spacing matches the per-level scale)."""
    return np.asarray(
        [1.0 / math.sqrt((i + 1) * (i + 2)) for i in range(d)], dtype=np.float32
    ) * (d + 1)


def normalize_capacities(capacity, n_levels: int) -> Tuple[int, ...]:
    """An int capacity (uniform) or per-level tuple -> per-level tuple."""
    if isinstance(capacity, (int, np.integer)):
        return (int(capacity),) * n_levels
    caps = tuple(int(c) for c in capacity)
    if len(caps) != n_levels:
        raise ValueError(f"{len(caps)} capacities for {n_levels} levels")
    return caps


def count_lattice_cells(
    scale: float, shifts_row, elev_scale, domain: float = 1.3, max_cells: int = 1 << 15
) -> int:
    """Empirical count of distinct permutohedral cells one level touches over
    the local domain [-domain, domain]^3 (numpy, init-time only). Sizes the
    dense coarse-level tables; levels too fine to probe return ``max_cells``.
    """
    d = 3
    n = int(2 * domain / max(scale * 0.45, 1e-9)) + 8
    if n > 112:  # cells outnumber any practical dense table: hashed level
        return max_cells
    g = np.linspace(-domain, domain, n, dtype=np.float64)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    cfs = (pts / scale + np.asarray(shifts_row)[None, :]) * np.asarray(elev_scale)[None, :]
    suffix = np.zeros((len(pts), d + 1))
    for i in range(d - 1, -1, -1):
        suffix[:, i] = suffix[:, i + 1] + cfs[:, i]
    elevated = np.concatenate(
        [suffix[:, :1], suffix[:, 1:] - np.arange(1, d + 1)[None] * cfs], axis=1
    )
    down = 1.0 / (d + 1)
    rem0 = np.round(elevated * down) * (d + 1)
    diff = elevated - rem0
    rank = np.zeros_like(rem0, dtype=np.int64)
    for i in range(d + 1):
        for j in range(i + 1, d + 1):
            smaller = diff[:, i] < diff[:, j]
            rank[:, i] += smaller
            rank[:, j] += ~smaller
    s = np.round(rem0.sum(-1) * down).astype(np.int64)
    r = rank + s[:, None]
    rem0 = rem0 + np.where(r < 0, d + 1, 0) - np.where(r > d, d + 1, 0)
    rank = r + np.where(r < 0, d + 1, 0) - np.where(r > d, d + 1, 0)
    keys = set()
    for k in range(d + 1):
        offset = np.where(rank[:, :d] < (d + 1 - k), k, k - (d + 1))
        key = rem0[:, :d].astype(np.int64) + offset
        keys.update(map(tuple, key))
        if len(keys) >= max_cells:
            return max_cells
    return len(keys)


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 for int64 ``a`` in [0, 2^32), overflow-free."""
    hi = ((a >> 16) * prime) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * prime) & _U32


def lattice_keys_and_weights_soa(
    coords,  # tuple of d tensors, each (..., P)
    scales: torch.Tensor,  # (L,)
    shifts: torch.Tensor,  # (L, d)
    elev_scale: torch.Tensor,  # (d,)
    capacity,  # int (uniform) or per-level tuple
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simplex corner hash indices and barycentric weights, points-minor.

    Returns:
        idx: (..., L, d+1, P) int64 hash-table indices per level and corner.
        w: (..., L, d+1, P) barycentric weights (sum to 1 over corners).
    """
    d = len(coords)
    cfs = [
        (coords[i][..., None, :] / scales[:, None] + shifts[:, i, None]) * elev_scale[i]
        for i in range(d)
    ]  # each (..., L, P)

    # Elevate onto the sum-zero hyperplane H_d.
    suffix = [None] * (d + 1)
    suffix[d] = torch.zeros_like(cfs[0])
    for i in range(d - 1, -1, -1):
        suffix[i] = suffix[i + 1] + cfs[i]
    elevated = [suffix[0]] + [suffix[i] - i * cfs[i - 1] for i in range(1, d + 1)]

    down = 1.0 / (d + 1)
    rem0 = [torch.round(e * down) * (d + 1) for e in elevated]  # half to even
    diff = [e - r for e, r in zip(elevated, rem0)]

    # rank[i] = #{j: diff[j] > diff[i]} with ties broken towards lower index
    rank = [torch.zeros_like(diff[0], dtype=torch.int64) for _ in range(d + 1)]
    for i in range(d + 1):
        for j in range(i + 1, d + 1):
            i_smaller = diff[i] < diff[j]
            rank[i] = rank[i] + i_smaller.long()
            rank[j] = rank[j] + (~i_smaller).long()

    # Fix points rounded off the hyperplane.
    s = torch.round(sum(rem0) * down).long()
    for i in range(d + 1):
        r = rank[i] + s
        low = r < 0
        high = r > d
        rank[i] = r + low.long() * (d + 1) - high.long() * (d + 1)
        rem0[i] = rem0[i] + low.float() * float(d + 1) - high.float() * float(d + 1)

    # Barycentric weights: bary[d - rank[i]] += v_i; bary[d + 1 - rank[i]] -= v_i
    v = [(e - r) * down for e, r in zip(elevated, rem0)]
    bary = [torch.zeros_like(v[0]) for _ in range(d + 2)]
    zero = torch.zeros_like(v[0])
    for i in range(d + 1):
        for b in range(d + 2):
            hit_hi = (d - rank[i]) == b
            hit_lo = (d + 1 - rank[i]) == b
            bary[b] = bary[b] + torch.where(hit_hi, v[i], zero) - torch.where(hit_lo, v[i], zero)
    bary[0] = bary[0] + 1.0 + bary[d + 1]
    w = torch.stack(bary[: d + 1], dim=-2)  # (..., L, d+1, P)

    # Hash the d+1 simplex corners; only the first d coordinates are hashed.
    caps = normalize_capacities(capacity, scales.shape[0])
    cap_mask = torch.tensor([c - 1 for c in caps], dtype=torch.int64, device=w.device)[:, None]
    idx_corners = []
    for k in range(d + 1):
        h = torch.zeros_like(rank[0])
        for i in range(d):
            offset = torch.where(rank[i] < (d + 1 - k), k, k - (d + 1))
            key_i = (rem0[i].long() + offset) & _U32  # two's complement wrap
            h = h ^ _mul_u32(key_i, HASH_PRIMES[i])
        idx_corners.append(h & cap_mask)
    idx = torch.stack(idx_corners, dim=-2)  # (..., L, d+1, P)
    return idx, w


def gather_blend_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[..., l*F + f, p] = sum_k table[..., f, l, idx[..., l, k, p]] * w[..., l, k, p].

    Args:
        table: (..., F, L, T) feature-MAJOR hash tables.
        idx: (..., L, K, P) int64 corner indices.
        w: (..., L, K, P) barycentric blend weights.

    Returns:
        (..., L*F, P) blended features, feature-major.
    """
    f = table.shape[-3]
    lead = idx.shape[:-3]
    l, k, p = idx.shape[-3:]
    flat_idx = idx.reshape(lead + (1, l, k * p)).expand(lead + (f, l, k * p))
    feats = torch.gather(table, -1, flat_idx).reshape(lead + (f, l, k, p))
    out = torch.sum(feats * w[..., None, :, :, :], dim=-2)  # (..., F, L, P)
    return out.transpose(-3, -2).reshape(lead + (l * f, p))


def _table_grad_fallback(idx: torch.Tensor, gv: torch.Tensor, table_size: int) -> torch.Tensor:
    """Scatter-add table gradient: idx (..., L, K, P) or (..., L, K*P), gv
    (..., L, F, K*P) -> (..., L, F, T), by one ``index_add_`` over the
    flattened table."""
    f, m = gv.shape[-2:]
    lead_l = gv.shape[:-2]  # (..., L)
    n_rows = math.prod(lead_l) * f
    base = torch.arange(n_rows, device=gv.device).reshape(lead_l + (f, 1)) * table_size
    flat = (base + idx.reshape(lead_l + (1, m))).reshape(-1)
    out = torch.zeros(n_rows * table_size, dtype=gv.dtype, device=gv.device)
    out.index_add_(0, flat, gv.reshape(-1))
    return out.reshape(lead_l + (f, table_size))


class _EncodeFused(torch.autograd.Function):
    """Forward: encode_fwd kernel. Backward: encode_bwd_table kernel for the
    table, zero for the coordinates (sample positions are not trained)."""

    @staticmethod
    def forward(ctx, table, coords, consts):
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        ctx.save_for_backward(coords)
        ctx.consts = consts
        return permuto_cuda.encode_fwd(table, coords, *consts)

    @staticmethod
    def backward(ctx, g):
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        (coords,) = ctx.saved_tensors
        grad_table = permuto_cuda.encode_bwd_table(coords, g.contiguous(), *ctx.consts)
        return grad_table, torch.zeros_like(coords), None


def encode_fused(table, coords, scales, shifts, elev, t_size):
    """table (..., 2, L, T) feature-major, coords (..., 3, P) -> (..., 2L, P).

    ``scales``, ``shifts``, ``elev`` and ``t_size`` (per-level capacities)
    are Python tuples: the kernels take them as launch constants.
    """
    return _EncodeFused.apply(table, coords, (scales, shifts, elev, t_size))


class _GatherBlend(torch.autograd.Function):
    """gather_blend on the gather route (permuto.gather_blend's custom VJP):
    the lookup is the ``gather_pairs`` kernel on the (..., L, F, T)-swapped
    table, the weight gradient is exact (gathered features . g), the table
    gradient is the ``table_grad`` kernel, and ``idx`` gets none."""

    @staticmethod
    def _feats(table, idx):
        """(..., L, F, K, P) corner features."""
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        lead = idx.shape[:-3]
        l, k, p = idx.shape[-3:]
        swapped = table.transpose(-3, -2).contiguous()  # (..., L, F, T)
        feats = permuto_cuda.gather_pairs(swapped, idx.reshape(lead + (l, k * p)))
        return feats.reshape(lead + (l, table.shape[-3], k, p))

    @staticmethod
    def forward(ctx, table, idx, w):
        ctx.save_for_backward(table, idx, w)
        feats = _GatherBlend._feats(table, idx)
        out = torch.sum(feats * w.unsqueeze(-3), dim=-2)  # (..., L, F, P)
        return out.reshape(out.shape[:-3] + (-1, out.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        table, idx, w = ctx.saved_tensors
        f, t = table.shape[-3], table.shape[-1]
        lead = idx.shape[:-3]
        l, k, p = idx.shape[-3:]
        g_r = g.reshape(lead + (l, f, 1, p))
        grad_table = grad_w = None
        if ctx.needs_input_grad[2]:
            # recomputed, as JAX does: cheaper than keeping (..., L, F, K, P)
            grad_w = torch.sum(_GatherBlend._feats(table, idx) * g_r, dim=-3)
        if ctx.needs_input_grad[0]:
            gv = (w.unsqueeze(-3) * g_r).reshape(lead + (l, f, k * p))
            grad_lf = permuto_cuda.table_grad(idx.reshape(lead + (l, k * p)), gv.contiguous(), t)
            grad_table = grad_lf.transpose(-3, -2)  # (..., F, L, T)
        return grad_table, None, grad_w


def gather_blend(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[..., l*F + f, p] = sum_k table[..., f, l, idx[..., l, k, p]] * w[..., l, k, p].

    The gather route (permuto.gather_blend): ``table`` (..., F, L, T)
    feature-major, ``idx`` (..., L, K, P) int64, ``w`` (..., L, K, P) ->
    (..., L*F, P). Differentiable in ``table`` and ``w``; on the card the
    kernels take 2 features per level.
    """
    return _GatherBlend.apply(table, idx, w)


class _EncodeMlpFused(torch.autograd.Function):
    """Forward: encode_mlp_fwd kernel, saving the feature residual. Backward:
    encode_mlp_bwd kernel for the table and the four weights, zero for the
    coordinates (sample positions are not trained)."""

    @staticmethod
    def forward(ctx, table, w0, b0, w1, b1, coords, consts):
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        out, feats = permuto_cuda.encode_mlp_fwd(table, w0, b0, w1, b1, coords, *consts)
        ctx.save_for_backward(coords, feats, w0, b0, w1)
        ctx.consts = consts
        return out

    @staticmethod
    def backward(ctx, g):
        from neural_graph_mapping_tpu_torch.ops import permuto_cuda

        coords, feats, w0, b0, w1 = ctx.saved_tensors
        grads = permuto_cuda.encode_mlp_bwd(coords, feats, g.contiguous(), w0, b0, w1, *ctx.consts)
        return (*grads, torch.zeros_like(coords), None)


def encode_mlp_fused(table, w0, b0, w1, b1, coords, scales, shifts, elev, t_size):
    """table (..., 2, L, T), w0 (..., 2L, H), b0 (..., H), w1 (..., H, O),
    b1 (..., O), coords (..., 3, P) -> (..., O, P): the encode and the field's
    one-hidden-layer ReLU MLP in one kernel each way (permuto.encode_mlp_fused).
    The lattice constants are Python tuples, as for :func:`encode_fused`.
    """
    return _EncodeMlpFused.apply(table, w0, b0, w1, b1, coords, (scales, shifts, elev, t_size))
