"""Field-axis sharding across ranks with ``torch.distributed`` (port of
neural_graph_mapping_tpu.parallel.sharding).

Fields are independent little networks except for the k-NN blend of
rendering and meshing and the loss normalisers, so the stacked per-field
state (hash tables, MLP weights, Adam moments and steps) is split over the
ranks of a process group along its leading field axis, and everything else
(the map registry, the keyframe cache, the host bookkeeping, the per-
iteration targets) stays replicated: every rank computes it alike from the
same draws. Where XLA inserts the JAX package's collectives, the port calls
them itself, and only these three, which the ``gloo`` backend takes on CUDA
tensors too: ``all_reduce`` (losses, render blends), ``all_gather``
(checkpoints, the capacity route) and ``broadcast``.

Layout: cyclic. Field ``f`` lives on rank ``f % W`` at local row ``f // W``
(JAX's mesh is block-sharded; the numbers do not depend on the layout).
With a capacity that divides by ``W``, a capacity doubling appends local
rows and no field changes rank, and newly allocated fields spread evenly
over the ranks.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class FieldGroup(NamedTuple):
    """The process group the field axis is split over, this process's rank
    in it and its size."""

    group: object
    rank: int
    size: int


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def make_field_group(
    num_shards: int,
    backend: str,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    device=None,
) -> FieldGroup:
    """The field axis's process group (JAX: ``make_field_mesh``).

    Joins the default process group if this process has none yet:
    ``init_method`` (e.g. ``"file:///tmp/pg"`` or ``"tcp://localhost:PORT"``)
    with ``rank``, or ``env://`` as ``torchrun`` sets it up (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT). The backend is explicit: ``nccl``
    needs one card per rank, ``gloo`` runs on the CPU and with several ranks
    on one card. Raises unless the group's size equals ``num_shards``, for
    ``nccl`` with a CPU device or with more ranks than cards (two ranks on
    one card), and for a backend other than the running group's; it never
    switches backend by itself.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device) if device is not None else None
    if backend == "nccl":
        if dev is not None and dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        local_ranks = _env_int("LOCAL_WORLD_SIZE") or num_shards
        if torch.cuda.device_count() < local_ranks:
            raise ValueError(
                f"nccl needs one card per rank: {local_ranks} ranks on this host, "
                f"{torch.cuda.device_count()} cards; use gloo for several ranks on one card"
            )
    if not dist.is_initialized():
        if init_method is None:
            init_method = "env://"
            world = _env_int("WORLD_SIZE")
            if world is None:
                raise RuntimeError(
                    f"num_field_shards={num_shards} needs a process group of that size: launch with "
                    f"torchrun --nproc_per_node={num_shards} (or pass init_method and rank)"
                )
            dist.init_process_group(backend, init_method=init_method)
        else:
            if rank is None:
                raise ValueError("init_method needs this process's rank")
            dist.init_process_group(backend, init_method=init_method, world_size=num_shards, rank=rank)
    running = dist.get_backend()
    if running != backend:
        raise ValueError(f"the process group runs {running!r}, not the {backend!r} asked for")
    size = dist.get_world_size()
    if size != num_shards:
        raise RuntimeError(
            f"num_field_shards={num_shards} but the process group has {size} ranks: launch with "
            f"torchrun --nproc_per_node={num_shards}"
        )
    return FieldGroup(dist.group.WORLD, dist.get_rank(), size)


def owned_mask(field_ids: torch.Tensor, fg: FieldGroup) -> torch.Tensor:
    """Which of the global ``field_ids`` this rank owns."""
    return field_ids % fg.size == fg.rank


def global_to_local(field_ids: torch.Tensor, fg: FieldGroup) -> torch.Tensor:
    """Global field ids -> local rows (valid where :func:`owned_mask`)."""
    return torch.div(field_ids, fg.size, rounding_mode="floor")


def local_rows(x: torch.Tensor, fg: FieldGroup) -> torch.Tensor:
    """This rank's rows of a full (N_cap, ...) tensor, in local order."""
    return x[fg.rank :: fg.size].contiguous()


def shard_field_tensors(tree: dict, fg: FieldGroup) -> dict:
    """A stacked-field dict (full leading axis) -> this rank's rows
    (JAX: ``shard_field_pytree``)."""
    return {k: local_rows(v, fg) for k, v in tree.items()}


def pad_fields_to_group(tree: dict, size: int) -> dict:
    """Pad the leading (field) axis of every leaf with zeros to a multiple
    of ``size`` (JAX: ``pad_fields_to_mesh``)."""

    def pad(x):
        rem = (-x.shape[0]) % size
        if rem == 0:
            return x
        return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])

    return {k: pad(v) for k, v in tree.items()}


def gather_field_tensors(tree: dict, fg: FieldGroup) -> dict:
    """This rank's rows of a stacked-field dict -> the full (N_cap, ...)
    tensors in global order, on every rank (one ``all_gather`` a leaf).
    Only checkpoints and the capacity-buffer route use it: it holds the
    whole state on every rank."""
    out = {}
    for k, v in tree.items():
        parts = [torch.empty_like(v) for _ in range(fg.size)]
        dist.all_gather(parts, v.contiguous(), group=fg.group)
        # parts[r][j] is field j * W + r
        out[k] = torch.stack(parts, dim=1).reshape((v.shape[0] * fg.size,) + tuple(v.shape[1:]))
    return out


def all_reduce_sum(x: torch.Tensor, fg: FieldGroup) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=fg.group)
    return x


def field_mean(x: torch.Tensor, fg: FieldGroup, capacity: int) -> torch.Tensor:
    """Mean over the whole field axis of a leaf whose local rows are ``x``."""
    total = x.detach().sum().reshape(1).clone()
    return all_reduce_sum(total, fg)[0] / (capacity * x[0].numel())


def knn_routing(fset, points: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor, fg: FieldGroup,
                field_radius: Optional[float] = None):
    """The global k-NN routing of ``points`` over the full (replicated)
    field centres, in the form ``NeuralFieldSet.apply_knn_tiled(routing=)``
    takes: (distances (P, k), local ids (P, k), owned (P, k), inside (P,)).
    k = 2 takes the ``topk2_fields`` kernel (exact, the unsharded tiled
    route's own), other k ``dispatch.topk_fields``."""
    from neural_graph_mapping_tpu_torch.ops import dispatch, topk

    radius = fset.field_radius if field_radius is None else field_radius
    if fset.num_knn == 2:
        d_fm, i_fm = topk.topk2_fields(points.T.contiguous(), positions.contiguous(), valid)
        dists, idx = d_fm.T, i_fm.T
    else:
        dists, idx = dispatch.topk_fields(points, positions, valid, fset.num_knn)
    inside = dists[:, 0] < radius
    owned = owned_mask(idx, fg)
    local = torch.where(owned, global_to_local(idx, fg), 0)
    return dists, local, owned, inside


def render_points_sharded(
    fset,
    params: dict,  # this rank's rows
    field_positions: torch.Tensor,  # (N_cap, 3) replicated
    field_orientations: torch.Tensor,  # (N_cap, 4) replicated
    field_valid: torch.Tensor,  # (N_cap,) replicated
    query_points: torch.Tensor,  # (P, 3) replicated
    fg: FieldGroup,
    field_radius: Optional[float] = None,
    ray_ctx: Optional[dict] = None,
) -> torch.Tensor:
    """k-NN-blended field evaluation with the field axis split over ranks
    -> (P, dim_out) on every rank, outside points ``fset.outside_value``.

    The routing is global and replicated (:func:`knn_routing` on the
    replicated centres); this rank evaluates only the (point, field) pairs
    whose field it owns, through ``apply_knn_tiled(routing=...,
    partial_blend=True)`` on its own rows (the ray encode with ``ray_ctx``,
    the carried encode otherwise), and one ``all_reduce`` of the (P,
    dim_out) contributions rebuilds the blend: it is linear in the pairs,
    and every pair's weight comes from the global distances. Collective
    traffic: P * dim_out floats a call.
    """
    routing = knn_routing(fset, query_points, field_positions, field_valid, fg, field_radius)
    part = fset.apply_knn_tiled(
        params, query_points, local_rows(field_positions, fg), local_rows(field_orientations, fg),
        local_rows(field_valid, fg), ray_ctx=ray_ctx, routing=routing, partial_blend=True,
    )
    out = all_reduce_sum(part.contiguous(), fg)
    return torch.where(routing[3][:, None], out, fset.outside_value)
