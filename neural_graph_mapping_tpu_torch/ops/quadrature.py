"""Volume-rendering quadrature (port of neural_graph_mapping_tpu.ops.quadrature):
the channel-major ``quadrature_fm`` of training and the channels-last
``quadrature`` of full-image rendering."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def occupancy_probs(
    geometry_mode: str,
    sample_geometries: torch.Tensor,
    sample_distances: torch.Tensor,
    geometry_factor: float,
    neus_isds: Optional[torch.Tensor] = None,
):
    """Per-sample occupancy probability + whether the last sample is dropped
    (density / occupancy / neus / nrgbd, as in the JAX package)."""
    if geometry_mode == "density":
        deltas = sample_distances[..., 1:] - sample_distances[..., :-1]
        occ = 1.0 - torch.exp(-deltas * torch.relu(sample_geometries[..., :-1]))
        drops_last = True
    elif geometry_mode == "occupancy":
        occ = 1.0 / (1.0 + torch.exp(-geometry_factor * sample_geometries))
        drops_last = False
    elif geometry_mode == "neus":
        if neus_isds is None:
            raise ValueError("neus mode requires neus_isds")
        tno = 1.0 / (1.0 + torch.exp(-neus_isds * geometry_factor * sample_geometries))
        occ = torch.relu((tno[..., :-1] - tno[..., 1:]) / (tno[..., :-1] + 1e-5))
        drops_last = True
    elif geometry_mode == "nrgbd":
        # symmetric bell around the surface: 4*s(t)*s(-t) == 4*s(t)*(1-s(t))
        sig = 1.0 / (1.0 + torch.exp(-(geometry_factor * sample_geometries)))
        occ = 4.0 * sig * (1.0 - sig)
        drops_last = False
    else:
        raise ValueError(f"Unknown geometry_mode {geometry_mode!r}")
    return occ, drops_last


class QuadratureResult(NamedTuple):
    colors: torch.Tensor  # (..., 3) expected ray color
    depths: torch.Tensor  # (...,) expected termination z-depth
    color_vars: torch.Tensor  # (..., 3)
    depth_vars: torch.Tensor  # (...,)
    term_probs: torch.Tensor  # (...,) P(ray terminates before far plane)
    sample_weights: torch.Tensor  # (..., S or S-1)


def _reversed_cumsum(w: torch.Tensor) -> torch.Tensor:
    return w.flip(-1).cumsum(-1).flip(-1)


def cumprod_grad(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``out = cumprod(x)`` along the last axis for the
    cotangent ``g``, by PyTorch's own formula (``cumprod_backward``), with
    the choice its host reads (``(x == 0).any().item()``) made per element
    on the device instead.

    With f the index of a row's first zero: before f, the reversed cumulative
    sum of ``out * g`` over ``x`` (the zero-free formula; ``out`` is 0 from f
    on); at f, ``out[f - 1] * sum_{j=f}^{z-1} g_j prod_{l=f+1}^{j} x_l``, with
    z the row's second zero; after f, 0. The same operations on the same
    values as PyTorch's, so the gradient equals its bit for bit."""
    is_zero = x == 0
    zeros_before = is_zero.cumsum(-1)
    before_first = zeros_before == 0
    dense = _reversed_cumsum((out * g).masked_fill(~before_first, 0.0)).div(x)
    # the first zero of each row, and the stretch after it up to the second
    in_first = zeros_before == 1
    first_idx = in_first.max(-1, keepdim=True).indices
    first = torch.zeros_like(in_first).scatter_(-1, first_idx, True) & in_first
    after_first = in_first & ~first
    run = x.masked_fill(~after_first, 1.0).cumprod(-1).mul(g.masked_fill(~in_first, 0.0)).sum(-1, keepdim=True)
    before = torch.gather(out, -1, (first_idx - 1).clamp(min=0)).masked_fill(first_idx == 0, 1.0)
    at_first = run.mul(before).expand_as(x)
    return torch.where(before_first, dense, torch.where(first, at_first, torch.zeros_like(x)))


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis whose backward never reads the
    device from the host (:func:`cumprod_grad`), so that a CUDA graph can
    capture it: PyTorch's ``CumprodBackward0`` reads whether the input holds
    a zero, and a capture forbids that read. The forward is
    ``torch.cumprod`` itself."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return cumprod_grad(x, out, g)


def cumprod(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumprod(x, dim=-1)``; where ``x`` needs a gradient, with the
    backward of :class:`_Cumprod`."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Cumprod.apply(x)
    return torch.cumprod(x, dim=-1)


def _termination_weights(occ: torch.Tensor) -> torch.Tensor:
    """Per-sample termination probability occ_s * prod_{j<s} (1 - occ_j)."""
    non_term = torch.cat([torch.ones_like(occ[..., :1]), cumprod(1.0 - occ[..., :-1])], dim=-1)
    return occ * non_term


def quadrature(
    geometry_mode: str,
    sample_colors: torch.Tensor,  # (..., S, 3)
    sample_geometries: torch.Tensor,  # (..., S)
    sample_distances: torch.Tensor,  # (..., S) ascending
    sample_depths: torch.Tensor,  # (..., S) z-depths
    geometry_factor: float = 1.0,
    neus_isds: Optional[torch.Tensor] = None,
) -> QuadratureResult:
    """Alpha-composite samples along rays, colors channels-last."""
    occ, drops_last = occupancy_probs(
        geometry_mode, sample_geometries, sample_distances, geometry_factor, neus_isds
    )
    weights = _termination_weights(occ)
    bg_weight = 1.0 - torch.sum(weights, dim=-1)

    last = -1 if drops_last else None
    colors_s = sample_colors[..., :last, :]
    depths_s = sample_depths[..., :last]
    colors = torch.sum(colors_s * weights[..., None], dim=-2)
    depths = torch.sum(depths_s * weights, dim=-1)
    color_vars = torch.sum(weights[..., None] * (colors[..., None, :] - colors_s) ** 2, dim=-2)
    depth_vars = torch.sum(weights * (depths[..., None] - depths_s) ** 2, dim=-1)
    return QuadratureResult(
        colors=colors,
        depths=depths,
        color_vars=color_vars,
        depth_vars=depth_vars,
        term_probs=1.0 - bg_weight,
        sample_weights=weights,
    )


class QuadratureResultFM(NamedTuple):
    colors: torch.Tensor  # (F, 3, R) channel-major expected ray colors
    depths: torch.Tensor  # (F, R)
    color_vars: torch.Tensor  # (F, 3, R)
    depth_vars: torch.Tensor  # (F, R)
    term_probs: torch.Tensor  # (F, R)


def quadrature_fm(
    geometry_mode: str,
    sample_colors: torch.Tensor,  # (F, 3, R, S) channel-major
    sample_geometries: torch.Tensor,  # (F, R, S)
    sample_distances: torch.Tensor,  # (F, R, S)
    sample_depths: torch.Tensor,  # (F, R, S)
    geometry_factor: float = 1.0,
    neus_isds: Optional[torch.Tensor] = None,
) -> QuadratureResultFM:
    """Alpha-composite samples along rays, colors channel-major."""
    occ, drops_last = occupancy_probs(
        geometry_mode, sample_geometries, sample_distances, geometry_factor, neus_isds
    )
    weights = _termination_weights(occ)
    bg_weight = 1.0 - torch.sum(weights, dim=-1)

    last = -1 if drops_last else None
    colors_s = sample_colors[..., :last]
    depths_s = sample_depths[..., :last]
    colors = torch.einsum("fcrs,frs->fcr", colors_s, weights)
    depths = torch.sum(depths_s * weights, dim=-1)
    color_vars = torch.einsum("fcrs,frs->fcr", (colors[..., None] - colors_s) ** 2, weights)
    depth_vars = torch.sum(weights * (depths[..., None] - depths_s) ** 2, dim=-1)
    return QuadratureResultFM(
        colors=colors,
        depths=depths,
        color_vars=color_vars,
        depth_vars=depth_vars,
        term_probs=1.0 - bg_weight,
    )
