"""NeuralGraphMap: the online dense neural mapping engine (port of
neural_graph_mapping_tpu.mapping.engine: the multi-view and single-view
frame steps, and full-image rendering through the tiled KNN route or the
capacity-buffer route).

Device side: one multi-view optimization iteration is field selection ->
multi-view target sampling -> field-parallel render -> losses -> per-field
Adam with gather/scatter; a frame writes the keyframe cache, tests which
fields the frame observes, and runs ``num_iterations_per_frame`` iterations
(the JAX package's ``lax.scan`` becomes a Python loop). With ``update_mode:
single_view`` an iteration trains on one cached view instead (the current
frame on odd iterations, a random keyframe otherwise) and draws its targets
from that view's depth cloud (``sampling.sample_target_sv``). Host side: the
pose graph, keyframe slot registry and kf->fields index, as in the JAX
package.

The frame step is written once. Its stages are functions here: the
iteration's targets (:func:`mv_target`, :func:`sv_target`), the gather of
the target fields (:func:`gather_targets`), their ray samples
(:func:`ray_samples`), the loss and its gradients (:func:`loss_and_grads`),
Adam and the training counts (:func:`adam_step`), and the observed-field
test (:func:`observed_fields`). :func:`frame_step` is the one frame loop
(cache writes, draws, the observed test or the single view's active mask,
the iterations), and the two scans share one iteration loop
(``_iterations``). A map's ``_graphs`` (set once, from
``frame_graphs.supported``) selects per stage: None runs each eagerly, a
``frame_graphs.FrameGraphs`` replays the observed test and each iteration
from CUDA graphs recorded from these same stage functions, on the card for
an unsharded map on the unfused encode. Setting it to None switches a map
to eager.

Randomness comes from ``torch.Generator``s on the engine's device; every
ported function also takes its draws as optional tensors
(:class:`IterationDraws`), and a map takes one optional :class:`DrawSource`
that hands it every draw of a frame (field init, the allocation grid's
shift, the observed-field test's Gumbel noise, each iteration's draws)
instead of its generators: that is how the tests replay a whole run of the
JAX package's draws, and how the smoke holds a run on the card to the same
run on the CPU.

Time accounting: ``phase_times`` sums the host phases of
:meth:`NeuralGraphMap.process_frame` (graph, alloc, host_misc; the CLI
runner adds data_wait and h2d), each timed by ``profiling.phase``, and
``throughput`` (a
:class:`~neural_graph_mapping_tpu_torch.utils.profiling.ThroughputTracker`)
gives ``fps_estimate`` / ``spf_estimate`` from the frames processed and their
optimization seconds. While the tracer is on (``utils/profiling.py``),
the frame, its phases, its step, each iteration's stages and each render
block's stages are spans ``ngm.frame.*``, ``ngm.iter.*``, ``ngm.render.*``.

Draw streams, as the JAX engine's two keys: ``_init_gen`` (JAX's ``_key``)
draws field init, render jitter and the single-view iterations (JAX feeds
its single-view scan from ``_next_key()``); ``_frame_gen`` (JAX's
``_base_key`` folded with the frame counter) draws the multi-view frame
programs and field allocation. So a render between frames moves later
single-view draws, in both packages, and never multi-view ones. The map's
``_step_generator`` says which one a frame step draws from (none under a
DrawSource), for both of its paths.

Field-axis sharding (config key ``num_field_shards: W``, a process group of
W ranks, ``parallel/sharding.py``): ``_params`` and ``_adam`` hold this
rank's rows of the cyclic layout (field f on rank f % W, row f // W); the
map arrays, the keyframe cache and the host bookkeeping stay replicated.
Every rank selects and samples all targets and draws every random tensor
at full size in one rank's order, then trains the targets it owns; the
loss terms' numerators and mask counts go through one ``all_reduce`` an
iteration (:func:`compute_losses_sharded`). Renders and meshes blend
through ``sharding.render_points_sharded``; the capacity-buffer route
evaluates on ``sharding.gather_field_tensors``' full copy.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import Dict, NamedTuple, Optional, Sequence, Set

import numpy as np
import torch

from neural_graph_mapping_tpu_torch.mapping import graph as graph_mod
from neural_graph_mapping_tpu_torch.mapping import map_state, optimizer, render, sampling
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import dispatch
from neural_graph_mapping_tpu_torch.ops import losses as losses_mod
from neural_graph_mapping_tpu_torch.ops import quadrature as quad_mod
from neural_graph_mapping_tpu_torch.parallel import sharding
from neural_graph_mapping_tpu_torch.utils import chunking, profiling, transforms

logger = logging.getLogger(__name__)


class IterationDraws(NamedTuple):
    """Random inputs of one optimization iteration; None = draw from the
    generator. Shapes: F = num_train_fields, R = rays per field, S = cache
    slots, N = field capacity."""

    u_obs: Optional[torch.Tensor] = None  # (N,) observed-field Gumbel uniforms
    u_rand: Optional[torch.Tensor] = None  # (N,) random-field Gumbel uniforms
    offsets: Optional[torch.Tensor] = None  # (20, 3) sphere offsets ~ N(0, 1)
    kf_gumbel: Optional[torch.Tensor] = None  # (F, R, S) keyframe choice noise
    pix_u: Optional[torch.Tensor] = None  # (F, R, 2) pixel uniforms
    u_coarse: Optional[torch.Tensor] = None  # (F, R, coarse) stratified uniforms
    u_guided: Optional[torch.Tensor] = None  # (F, R, guided) stratified uniforms
    # single view
    slot_gumbel: Optional[torch.Tensor] = None  # (S,) keyframe choice noise
    cloud_idx: Optional[torch.Tensor] = None  # (50,000,) depth-cloud pixel draws
    u_fields: Optional[torch.Tensor] = None  # (N,) eligible-field Gumbel uniforms
    u_rays: Optional[torch.Tensor] = None  # (F, R) ray uniforms


class DrawShapes(NamedTuple):
    """The sizes a frame's draws take: N = field capacity, F = target
    fields, R = rays per field, S = keyframe-cache slots, the coarse and
    depth-guided samples per ray, and the frame's H x W."""

    capacity: int
    num_train_fields: int
    num_rays: int
    num_slots: int
    num_coarse: int
    num_guided: int
    height: int
    width: int


class DrawSource:
    """Every random draw of a map's frames, in place of its generators.

    ``NeuralGraphMap(config, device, draws=source)`` calls these where it
    would draw; each returns tensors on the map's device (so the map adds no
    copy and no host sync), shaped as :class:`DrawShapes` says.
    ``frame_counter`` is the map's frame counter, 1 for the first frame,
    as the JAX engine folds it into its frame keys. Without a source (the
    default) the map draws from ``_init_gen`` / ``_frame_gen``.
    """

    def init_fields(self, num_fields: int) -> dict:
        """Stacked parameters for ``num_fields`` new fields (at construction
        and at each capacity growth; JAX: ``init_fields(_next_key(), n)``)."""
        raise NotImplementedError

    def allocation_shift(self, frame_counter: int) -> torch.Tensor:
        """(3,) allocation-grid shift ~ U(0, cell) for a keyframe."""
        raise NotImplementedError

    def observed_gumbel(self, frame_counter: int, shapes: DrawShapes, num_points: int) -> torch.Tensor:
        """(num_points, H * W) Gumbel noise of the observed-field test."""
        raise NotImplementedError

    def multi_view(self, frame_counter: int, num_iters: int, shapes: DrawShapes) -> list:
        """Each multi-view iteration's :class:`IterationDraws` (u_obs,
        u_rand, offsets, kf_gumbel, pix_u, u_coarse, u_guided)."""
        raise NotImplementedError

    def single_view(self, num_iters: int, shapes: DrawShapes, cache_depth: torch.Tensor,
                    cache_valid: torch.Tensor) -> list:
        """Each single-view iteration's :class:`IterationDraws` (slot_gumbel,
        cloud_idx, u_fields, u_rays, u_coarse, u_guided); the cloud is drawn
        over the valid pixels of the view the iteration trains on, which the
        cache says."""
        raise NotImplementedError


class LossConfig(NamedTuple):
    """Loss hyperparameters."""

    termination_weight: float = 0.0
    photometric_weight: float = 1.0
    photometric_loss: str = "l1"
    depth_weight: float = 1.0
    depth_loss: str = "huber"
    freespace_weight: float = 40.0
    tsdf_weight: float = 50.0
    num_rays_per_field: int = 512
    # debug filter: restrict field selection to this field
    single_field_id: Optional[int] = None


def compute_losses(
    cfg: LossConfig,
    rcfg: render.RenderConfig,
    target: sampling.Target,
    pred: render.Prediction,
):
    """Assemble the training loss. Depth/rgb are supervised only where the
    target depth is usable AND the predicted termination prob exceeds 0.8."""
    depth_mask = target.depth_mask & (pred.term_probs > 0.8)
    rgb_mask = depth_mask

    loss_dict = {}
    termination = losses_mod.termination_loss(pred.term_probs, target.term_probs, target.term_mask)
    loss_dict["termination"] = termination
    combined = cfg.termination_weight * termination

    photometric = losses_mod.photometric_loss(
        cfg.photometric_loss, target.rgbds[..., :3], pred.rgbds[..., :3], pred.color_vars,
        mask=rgb_mask,
    )
    loss_dict[f"photometric_{cfg.photometric_loss}"] = photometric
    combined = combined + cfg.photometric_weight * photometric

    depth = losses_mod.depth_loss(
        cfg.depth_loss, target.rgbds[..., 3], pred.rgbds[..., 3], pred.depth_vars,
        mask=depth_mask,
    )
    loss_dict[f"depth_{cfg.depth_loss}"] = depth
    combined = combined + cfg.depth_weight * depth

    if cfg.freespace_weight != 0.0:
        freespace = losses_mod.freespace_loss(
            pred.sample_geometries, rcfg.truncation_distance, pred.freespace_mask
        )
        loss_dict["freespace"] = freespace
        combined = combined + cfg.freespace_weight * freespace

    if cfg.tsdf_weight != 0.0:
        deltas = target.gt_distances[..., None] - pred.sample_distances
        tsdf = losses_mod.tsdf_loss(
            pred.sample_geometries, deltas, rcfg.truncation_distance, pred.tsdf_mask
        )
        loss_dict["tsdf"] = tsdf
        combined = combined + cfg.tsdf_weight * tsdf

    # supervision-coverage diagnostics (not losses)
    loss_dict["diag_depth_mask_frac"] = torch.mean(depth_mask.float())
    loss_dict["diag_term_mask_frac"] = torch.mean(target.term_mask.float())
    loss_dict["diag_valid_fields"] = torch.sum(target.field_valid.float())
    loss_dict["combined"] = combined
    return combined, loss_dict


def _loss_layout(cfg: LossConfig):
    """compute_losses' terms in order: (key, weight, values a term has)."""
    terms = [
        ("termination", cfg.termination_weight, 1),
        (f"photometric_{cfg.photometric_loss}", cfg.photometric_weight,
         2 if cfg.photometric_loss == "gaussian_nll" else 1),
        (f"depth_{cfg.depth_loss}", cfg.depth_weight, 1),
    ]
    if cfg.freespace_weight != 0.0:
        terms.append(("freespace", cfg.freespace_weight, 1))
    if cfg.tsdf_weight != 0.0:
        terms.append(("tsdf", cfg.tsdf_weight, 1))
    return terms


def _loss_sums(cfg: LossConfig, rcfg: render.RenderConfig, target: sampling.Target, pred: render.Prediction):
    """Each term of :func:`compute_losses` as (numerators, mask count) on
    these targets, in :func:`_loss_layout`'s order, and the diagnostics'
    counts (depth-mask rays, term-mask rays, valid fields)."""
    depth_mask = target.depth_mask & (pred.term_probs > 0.8)
    inputs = [
        ((losses_mod.termination_values(pred.term_probs, target.term_probs),), target.term_mask),
        (losses_mod.photometric_values(cfg.photometric_loss, target.rgbds[..., :3], pred.rgbds[..., :3],
                                       pred.color_vars), depth_mask[..., None]),
        ((losses_mod.depth_values(cfg.depth_loss, target.rgbds[..., 3], pred.rgbds[..., 3], pred.depth_vars),),
         depth_mask),
    ]
    if cfg.freespace_weight != 0.0:
        inputs.append(((losses_mod.freespace_values(pred.sample_geometries, rcfg.truncation_distance),),
                       pred.freespace_mask))
    if cfg.tsdf_weight != 0.0:
        deltas = target.gt_distances[..., None] - pred.sample_distances
        inputs.append(((losses_mod.tsdf_values(pred.sample_geometries, deltas, rcfg.truncation_distance),),
                       pred.tsdf_mask))
    sums = []
    for values, mask in inputs:
        nums, den = [], None
        for v in values:
            num, den = losses_mod.masked_sums(v, mask)
            nums.append(num)
        sums.append((nums, den))
    diag = [depth_mask.float().sum(), target.term_mask.float().sum(), target.field_valid.float().sum()]
    return sums, diag


def compute_losses_sharded(
    cfg: LossConfig,
    rcfg: render.RenderConfig,
    target: Optional[sampling.Target],
    pred: Optional[render.Prediction],
    num_rays: int,
    shard: sharding.FieldGroup,
    device,
):
    """:func:`compute_losses` over targets split across ranks: every masked
    mean spans all ranks' targets. This rank's numerators and mask counts
    of every term, and the diagnostics' counts, go through one
    ``all_reduce`` (detached); the rank's differentiable loss is then
    ``sum(weight * local numerator / global count)``, whose gradient on
    this rank's fields is the unsharded loss's, and the gaussian
    photometric branch is taken on the global NLL mean. ``target`` /
    ``pred`` None: this rank trains no target this iteration (it still
    joins the collective). ``num_rays``: all ranks' target rays (F * R).
    Returns (the local loss or None, the global loss dict, on every rank)."""
    layout = _loss_layout(cfg)
    if target is not None:
        sums, diag = _loss_sums(cfg, rcfg, target, pred)
    else:
        zero = torch.zeros((), device=device)
        sums = [([zero] * n, zero) for _, _, n in layout]
        diag = [zero] * 3
    flat = [x.detach() for nums, den in sums for x in nums + [den]] + [d.detach() for d in diag]
    totals = sharding.all_reduce_sum(torch.stack(flat).float(), shard)
    loss_dict, local, i = {}, 0.0, 0
    combined = 0.0
    for (key, weight, n), (nums, _) in zip(layout, sums):
        g_nums, g_den = totals[i : i + n], torch.clamp(totals[i + n], min=1.0)
        i += n + 1
        means = g_nums / g_den
        locs = [num / g_den for num in nums]
        if n == 2:  # gaussian NLL: the absolute error where the NLL mean passes 2
            branch = means[0] > 2.0
            value, loc = torch.where(branch, means[1], means[0]), torch.where(branch, locs[1], locs[0])
        else:
            value, loc = means[0], locs[0]
        loss_dict[key] = value
        combined = combined + weight * value
        local = local + weight * loc
    loss_dict["diag_depth_mask_frac"] = totals[i] / num_rays
    loss_dict["diag_term_mask_frac"] = totals[i + 1] / num_rays
    loss_dict["diag_valid_fields"] = totals[i + 2]
    loss_dict["combined"] = combined
    return (local if target is not None else None), loss_dict


def gather_targets(fset: NeuralFieldSet, params: dict, map_positions, map_orientations, target: sampling.Target):
    """The target fields' parameters, positions and orientations, each with
    leading axis F -> (sub_params, sub_positions, sub_orientations)."""
    ids = target.field_ids
    return fset.gather_fields(params, ids), map_positions[ids], map_orientations[ids]


def ray_samples(fset: NeuralFieldSet, camera, rcfg: render.RenderConfig, target: sampling.Target, sub_positions,
                sub_orientations, draws: IterationDraws, generator: Optional[torch.Generator]):
    """The target rays' samples (``render.sample_rays``) -> (the samples,
    their coordinates in each target field's frame, 3 x (F, R*S))."""
    samples = render.sample_rays(camera, target, rcfg, draws.u_coarse, draws.u_guided, generator)
    return samples, fset.world_to_local_soa(samples.points, sub_positions, sub_orientations)


def _predict(fset: NeuralFieldSet, camera, rcfg: render.RenderConfig, sub_params: dict, sub_positions,
             sub_orientations, target: sampling.Target, draws: IterationDraws,
             generator: Optional[torch.Generator], cut: Optional[tuple] = None):
    """The target rays rendered through the gathered fields -> (the leaves
    the loss is differentiated by, the prediction); ``cut``: see
    :func:`loss_and_grads`."""
    if cut is None:
        samples, coords = ray_samples(fset, camera, rcfg, target, sub_positions, sub_orientations, draws, generator)
        leaves = {k: v.detach().requires_grad_(True) for k, v in sub_params.items()}
        outs = fset.prototype.apply_fm_soa(leaves, coords)  # (F, 4, R*S)
    else:
        samples, encoded = cut
        leaves = {k: v.detach().requires_grad_(True) for k, v in {**sub_params, "enc.table": encoded}.items()}
        outs = fset.prototype.mlp_fm(leaves, leaves["enc.table"])
    return leaves, render.composite(leaves, target, samples, outs, rcfg)


def loss_and_grads(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    loss_cfg: LossConfig,
    sub_params: dict,
    sub_positions: Optional[torch.Tensor],
    sub_orientations: Optional[torch.Tensor],
    target: sampling.Target,
    draws: IterationDraws = IterationDraws(),
    generator: Optional[torch.Generator] = None,
    cut: Optional[tuple] = None,
):
    """Render the target's rays through the gathered fields, take the losses
    and their gradients w.r.t. ``sub_params`` -> (loss_dict, grads).
    ``cut``: a graphed iteration's (ray samples, encoded features at them),
    from its pre graph and the eager ``encode_fwd`` (``frame_graphs``): the
    fields' MLP runs from those features, the poses are not read, and the
    gradient under ``enc.table`` is d loss / d the features."""
    with profiling.span("ngm.iter.render"):
        leaves, pred = _predict(fset, camera, rcfg, sub_params, sub_positions, sub_orientations, target, draws,
                                generator, cut)
    with profiling.span("ngm.iter.loss"):
        combined, loss_dict = compute_losses(loss_cfg, rcfg, target, pred)
    with profiling.span("ngm.iter.backward"):
        grads = _grads(combined, leaves)
    return {k: v.detach() for k, v in loss_dict.items()}, grads


def _grads(loss: torch.Tensor, leaves: dict) -> dict:
    """d loss / d each leaf (zeros for a leaf the loss does not reach)."""
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)}


def adam_step(ocfg: optimizer.AdamConfig, params: dict, adam: optimizer.AdamState, training_iterations,
              target: sampling.Target, grads: dict, sub_params: dict) -> None:
    """Per-field Adam on the target fields (``optimizer.adam_slice_update``)
    and their training counts, in place."""
    optimizer.adam_slice_update(ocfg, params, adam, target.field_ids, target.field_valid, grads, sub_params)
    training_iterations.index_add_(0, target.field_ids, target.field_valid.to(training_iterations.dtype))


def _sharded_iteration_core(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,
    map_positions: torch.Tensor,
    map_orientations: torch.Tensor,
    target: sampling.Target,
    draws: IterationDraws,
    generator: Optional[torch.Generator],
    shard: sharding.FieldGroup,
):
    """:func:`_optimization_iteration_core` with the field axis split over
    ranks: ``params`` / ``adam`` are this rank's rows, ``target`` is every
    rank's (replicated). The render's draws are taken at full size, as one
    rank draws them, then this rank renders and steps Adam on the targets
    it owns; the losses span every rank's (:func:`compute_losses_sharded`).
    One host sync: the count of owned targets. Adam and the training counts
    are its own lines, not :func:`adam_step`: Adam steps the owned targets'
    local rows, and the counts take every rank's targets, also where this
    rank owns none."""
    f, r = target.near_distances.shape
    dev = target.rgbds.device
    u_coarse, u_guided = draws.u_coarse, draws.u_guided
    if u_coarse is None:
        u_coarse = torch.rand((f, r, rcfg.num_samples_coarse), generator=generator, device=dev)
    if u_guided is None and rcfg.num_samples_depth_guided > 0:
        u_guided = torch.rand((f, r, rcfg.num_samples_depth_guided), generator=generator, device=dev)
    slots = torch.nonzero(sharding.owned_mask(target.field_ids, shard)).squeeze(1)
    if slots.numel() == 0:
        _, loss_dict = compute_losses_sharded(loss_cfg, rcfg, None, None, f * r, shard, dev)
    else:
        local = sampling.Target(*(x.index_select(0, slots) for x in target))
        rows = sharding.global_to_local(local.field_ids, shard)
        sub_params = fset.gather_fields(params, rows)
        local_draws = IterationDraws(u_coarse=u_coarse[slots], u_guided=None if u_guided is None else u_guided[slots])
        leaves, pred = _predict(fset, camera, rcfg, sub_params, map_positions[local.field_ids],
                                map_orientations[local.field_ids], local, local_draws, None)
        loss, loss_dict = compute_losses_sharded(loss_cfg, rcfg, local, pred, f * r, shard, dev)
        optimizer.adam_slice_update(
            ocfg, params, adam, rows, local.field_valid, _grads(loss, leaves), sub_params
        )
    training_iterations.index_add_(
        0, target.field_ids, target.field_valid.to(training_iterations.dtype)
    )
    return params, adam, training_iterations, {k: v.detach() for k, v in loss_dict.items()}


def _optimization_iteration_core(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,
    map_positions: torch.Tensor,
    map_orientations: torch.Tensor,
    target: sampling.Target,
    draws: IterationDraws = IterationDraws(),
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
):
    """Render + losses + per-field Adam for a pre-built target: the stages
    :func:`gather_targets`, :func:`loss_and_grads`, :func:`adam_step`.
    Updates ``params``, ``adam`` and ``training_iterations`` in place. With
    ``shard``, :func:`_sharded_iteration_core`."""
    if shard is not None:
        return _sharded_iteration_core(
            fset, camera, rcfg, ocfg, loss_cfg, params, adam, training_iterations, map_positions,
            map_orientations, target, draws, generator, shard,
        )
    with profiling.span("ngm.iter.gather"):
        sub_params, sub_positions, sub_orientations = gather_targets(
            fset, params, map_positions, map_orientations, target
        )
    loss_dict, grads = loss_and_grads(
        fset, camera, rcfg, loss_cfg, sub_params, sub_positions, sub_orientations,
        target, draws, generator,
    )
    with profiling.span("ngm.iter.adam"):
        adam_step(ocfg, params, adam, training_iterations, target, grads, sub_params)
    return params, adam, training_iterations, loss_dict


def optimization_iteration(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    num_train_fields: int,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,  # (N_cap,)
    map_positions: torch.Tensor,  # (N_cap, 3)
    map_orientations: torch.Tensor,  # (N_cap, 4)
    allocated_mask: torch.Tensor,  # (N_cap,)
    observed_mask: torch.Tensor,  # (N_cap,)
    cache_rgb: torch.Tensor,  # (S, H, W, 3)
    cache_depth: torch.Tensor,  # (S, H, W)
    cache_c2w: torch.Tensor,  # (S, 4, 4)
    cache_valid: torch.Tensor,  # (S,)
    draws: IterationDraws = IterationDraws(),
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
):
    """One multi-view optimization iteration (selection, sampling, render,
    losses, Adam); returns (params, adam, training_iterations, loss_dict).
    With ``shard``, ``params`` and ``adam`` are this rank's rows."""
    target = mv_target(
        fset, camera, loss_cfg, num_train_fields, map_positions, allocated_mask, observed_mask, cache_rgb,
        cache_depth, cache_c2w, cache_valid, draws, generator,
    )
    return _optimization_iteration_core(
        fset, camera, rcfg, ocfg, loss_cfg, params, adam, training_iterations,
        map_positions, map_orientations, target, draws, generator, shard,
    )


def mv_target(
    fset: NeuralFieldSet,
    camera,
    loss_cfg: LossConfig,
    num_train_fields: int,
    map_positions: torch.Tensor,
    allocated_mask: torch.Tensor,
    observed_mask: torch.Tensor,
    cache_rgb: torch.Tensor,
    cache_depth: torch.Tensor,
    cache_c2w: torch.Tensor,
    cache_valid: torch.Tensor,
    draws: IterationDraws,
    generator: Optional[torch.Generator],
) -> sampling.Target:
    """A multi-view iteration's targets: half observed, half random fields
    (``sampling.select_target_fields``), then their rays from the keyframe
    cache (``sampling.sample_target_mv``)."""
    if loss_cfg.single_field_id is not None:
        only = torch.arange(allocated_mask.shape[0], device=allocated_mask.device) == loss_cfg.single_field_id
        allocated_mask = allocated_mask & only
        observed_mask = observed_mask & only
    with profiling.span("ngm.iter.select"):
        field_ids, field_valid = sampling.select_target_fields(
            observed_mask, allocated_mask, num_train_fields, draws.u_obs, draws.u_rand, generator
        )
    with profiling.span("ngm.iter.sample"):
        return sampling.sample_target_mv(
            camera, field_ids, field_valid, map_positions, cache_rgb, cache_depth, cache_c2w,
            cache_valid, fset.field_radius, loss_cfg.num_rays_per_field,
            offsets=draws.offsets, kf_gumbel=draws.kf_gumbel, pix_u=draws.pix_u,
            generator=generator,
        )


def _iterations(num_iters: int, iteration_draws, graphs, camera, maps: tuple, step, targets, inputs) -> dict:
    """The loop of both scans; ``maps`` = (params, adam, training_iterations,
    map positions, orientations, the keyframe cache), all updated in place.
    Iteration i is ``step(i, draws)``, the eager iteration, which returns its
    loss dict; or, given ``graphs`` (a :class:`frame_graphs.FrameGraphs`),
    the engine's stages replayed from CUDA graphs around ``targets(buffers,
    draws, generator)``, the iteration's target stage over the graphs'
    buffers of ``inputs(i)``. -> the last iteration's loss dict."""
    loss_dict = {}
    for i in range(num_iters):
        profiling.count("step.iterations")
        draws = iteration_draws[i] if iteration_draws else IterationDraws()
        eager = functools.partial(step, i, draws)
        loss_dict = eager() if graphs is None else graphs.iteration(camera, maps, targets, inputs(i), draws, eager)
    return loss_dict


def optimization_iterations_scan(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    num_train_fields: int,
    num_iters: int,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,
    map_positions: torch.Tensor,
    map_orientations: torch.Tensor,
    allocated_mask: torch.Tensor,
    observed_mask: torch.Tensor,
    cache_rgb: torch.Tensor,
    cache_depth: torch.Tensor,
    cache_c2w: torch.Tensor,
    cache_valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
    iteration_draws: Optional[Sequence[IterationDraws]] = None,
    graphs=None,
):
    """``num_iters`` iterations (:func:`optimization_iteration`), each
    resampling its targets (iteration i from ``iteration_draws[i]`` where
    given), eagerly or from ``graphs`` (:func:`_iterations`); returns the
    state, updated in place, and the last iteration's loss dict. No host
    syncs (sharded: one an iteration)."""
    cache = (cache_rgb, cache_depth, cache_c2w, cache_valid)

    def step(i, draws):
        return optimization_iteration(
            fset, camera, rcfg, ocfg, loss_cfg, num_train_fields, params, adam, training_iterations,
            map_positions, map_orientations, allocated_mask, observed_mask, *cache,
            draws=draws, generator=generator, shard=shard,
        )[3]

    def targets(inputs, draws, gen):
        return mv_target(fset, camera, loss_cfg, num_train_fields, map_positions, inputs["allocated"],
                         inputs["mask"], *cache, draws, gen)

    maps = (params, adam, training_iterations, map_positions, map_orientations, cache)
    loss_dict = _iterations(num_iters, iteration_draws, graphs, camera, maps, step, targets,
                            lambda i: {"allocated": allocated_mask, "mask": observed_mask})
    return params, adam, training_iterations, loss_dict


def optimization_iteration_sv(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    num_train_fields: int,
    iter_idx: int,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,  # (N_cap,)
    map_positions: torch.Tensor,  # (N_cap, 3)
    map_orientations: torch.Tensor,  # (N_cap, 4)
    active_mask: torch.Tensor,  # (N_cap,) BFS-active fields
    cache_rgb: torch.Tensor,  # (S, H, W, 3)
    cache_depth: torch.Tensor,  # (S, H, W)
    cache_c2w: torch.Tensor,  # (S, 4, 4)
    cache_valid: torch.Tensor,  # (S,)
    draws: IterationDraws = IterationDraws(),
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
):
    """One single-view optimization iteration (the body of the JAX
    package's ``optimization_iterations_scan_sv``): :func:`sv_target`, then
    render, losses and Adam as in the multi-view iteration. Returns
    (params, adam, training_iterations, loss_dict). No host sync."""
    target = sv_target(
        fset, camera, loss_cfg, num_train_fields, map_positions, active_mask, iter_idx % 2 != 0, cache_rgb,
        cache_depth, cache_c2w, cache_valid, draws, generator,
    )
    return _optimization_iteration_core(
        fset, camera, rcfg, ocfg, loss_cfg, params, adam, training_iterations,
        map_positions, map_orientations, target, draws, generator, shard,
    )


def sv_target(fset: NeuralFieldSet, camera, loss_cfg: LossConfig, num_train_fields: int, map_positions,
              active_mask, odd, cache_rgb, cache_depth, cache_c2w, cache_valid, draws: IterationDraws,
              generator: Optional[torch.Generator]) -> sampling.Target:
    """A single-view iteration's targets. Its view (span ``ngm.iter.select``):
    the current frame (slot 0) where ``odd`` (a Python bool or a 0-d bool
    tensor: the iteration's parity) and it is valid, else a random valid
    keyframe slot other than 0. Then that view's RGB-D gathered (span
    ``ngm.iter.sv_cloud``: the sampler draws its cloud next) and its targets
    from its depth cloud against the active fields (``sampling.sample_target_sv``)."""
    with profiling.span("ngm.iter.select"):
        slot_gumbel = draws.slot_gumbel
        if slot_gumbel is None:
            slot_gumbel = sampling.gumbel_noise(cache_valid.shape, generator, cache_valid.device)
        others = torch.cat([torch.zeros_like(cache_valid[:1]), cache_valid[1:]])
        random_slot = torch.argmax(slot_gumbel + torch.where(others, 0.0, -torch.inf))
        slot = torch.where(cache_valid[0] & odd, 0, random_slot).reshape(1)
    with profiling.span("ngm.iter.sample"):
        with profiling.span("ngm.iter.sv_cloud"):
            view = torch.cat([cache_rgb.index_select(0, slot)[0].float(),
                              cache_depth.index_select(0, slot)[0][..., None]], dim=-1)
        return sampling.sample_target_sv(
            camera, view, cache_c2w.index_select(0, slot)[0], map_positions, active_mask, fset.field_radius,
            num_train_fields, loss_cfg.num_rays_per_field, cloud_idx=draws.cloud_idx, u_fields=draws.u_fields,
            u_rays=draws.u_rays, generator=generator,
        )


def optimization_iterations_scan_sv(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    num_train_fields: int,
    num_iters: int,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,
    map_positions: torch.Tensor,
    map_orientations: torch.Tensor,
    active_mask: torch.Tensor,
    cache_rgb: torch.Tensor,
    cache_depth: torch.Tensor,
    cache_c2w: torch.Tensor,
    cache_valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
    iteration_draws: Optional[Sequence[IterationDraws]] = None,
    graphs=None,
):
    """``num_iters`` single-view iterations (:func:`optimization_iteration_sv`,
    iteration i choosing its view by i's parity, from ``iteration_draws[i]``
    where given), eagerly or from ``graphs`` (:func:`_iterations`); returns
    the state, updated in place, and the last iteration's loss dict. No host
    syncs (sharded: one an iteration)."""
    cache = (cache_rgb, cache_depth, cache_c2w, cache_valid)

    def step(i, draws):
        return optimization_iteration_sv(
            fset, camera, rcfg, ocfg, loss_cfg, num_train_fields, i, params, adam, training_iterations,
            map_positions, map_orientations, active_mask, *cache, draws=draws, generator=generator, shard=shard,
        )[3]

    def targets(inputs, draws, gen):
        return sv_target(fset, camera, loss_cfg, num_train_fields, map_positions, inputs["mask"], inputs["odd"],
                         *cache, draws, gen)

    maps = (params, adam, training_iterations, map_positions, map_orientations, cache)
    loss_dict = _iterations(num_iters, iteration_draws, graphs, camera, maps, step, targets,
                            lambda i: {"mask": active_mask, "odd": i % 2 != 0})
    return params, adam, training_iterations, loss_dict


def write_cache(cache_rgb, cache_depth, rgbd, write_current: bool, kf_slot: int) -> None:
    """Write the frame (H, W, 4) into the keyframe cache in place: to slot 0
    (the current frame) if ``write_current``, and to ``kf_slot`` if >= 0."""
    rgb = rgbd[..., :3].to(cache_rgb.dtype)
    depth = rgbd[..., 3]
    if write_current:
        cache_rgb[0] = rgb
        cache_depth[0] = depth
    if kf_slot >= 0:
        cache_rgb[kf_slot] = rgb
        cache_depth[kf_slot] = depth


def observed_fields(fset: NeuralFieldSet, camera, depth, c2w, map_positions, allocated_mask,
                    gumbel: Optional[torch.Tensor], generator: Optional[torch.Generator]) -> torch.Tensor:
    """The frame's observed-field test (``sampling.observed_fields_mask``)
    on its depth (H, W) and pose -> (N_cap,) bool."""
    return sampling.observed_fields_mask(camera, depth, c2w, map_positions, allocated_mask, fset.field_radius,
                                         gumbel=gumbel, generator=generator)


def draw_shapes(rcfg: render.RenderConfig, loss_cfg: LossConfig, num_train_fields: int, map_positions,
                cache_depth) -> DrawShapes:
    """The sizes of a frame's draws, from the map's capacity and cache."""
    num_slots, height, width = cache_depth.shape
    return DrawShapes(map_positions.shape[0], num_train_fields, loss_cfg.num_rays_per_field, num_slots,
                      rcfg.num_samples_coarse, rcfg.num_samples_depth_guided, height, width)


def frame_step(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    ocfg: optimizer.AdamConfig,
    loss_cfg: LossConfig,
    num_train_fields: int,
    num_iters: int,
    write_current: bool,
    has_fields: bool,
    params: dict,
    adam: optimizer.AdamState,
    training_iterations: torch.Tensor,
    map_positions: torch.Tensor,
    map_orientations: torch.Tensor,
    allocated_mask: torch.Tensor,
    cache_rgb: torch.Tensor,
    cache_depth: torch.Tensor,
    cache_c2w: torch.Tensor,
    cache_valid: torch.Tensor,
    rgbd: torch.Tensor,  # (H, W, 4) current frame
    c2w: torch.Tensor,  # (4, 4)
    kf_slot: int,  # < 0 -> not a keyframe
    generator: Optional[torch.Generator] = None,
    shard: Optional[sharding.FieldGroup] = None,
    draws: Optional[DrawSource] = None,
    frame_counter: int = 0,
    active_mask: Optional[torch.Tensor] = None,  # (N_cap,) single view: the BFS-active fields
    graphs=None,
):
    """One frame: keyframe-cache writes (in place); the frame's draws from
    ``draws``, a :class:`DrawSource` called with ``frame_counter``, where
    given, else each from ``generator``; then the observed-field test and
    the multi-view iterations over it, or, given ``active_mask``, the
    single-view iterations over those fields; iterations where
    ``has_fields``. ``graphs``: a :class:`frame_graphs.FrameGraphs` whose
    CUDA graphs the observed test and each iteration replay; None: eagerly.
    -> (params, adam, training_iterations, cache_rgb, cache_depth, the
    observed mask or None, the last iteration's loss dict)."""
    single_view = active_mask is not None
    cache = (cache_rgb, cache_depth, cache_c2w, cache_valid)
    with profiling.span("ngm.frame.cache_write"):
        write_cache(cache_rgb, cache_depth, rgbd, write_current, kf_slot)
    observed_gumbel = iteration_draws = observed = None
    if draws is not None and (has_fields or not single_view):
        with profiling.span("ngm.frame.draws"):
            shapes = draw_shapes(rcfg, loss_cfg, num_train_fields, map_positions, cache_depth)
            if single_view:
                iteration_draws = draws.single_view(num_iters, shapes, cache_depth, cache_valid)
            else:
                observed_gumbel = draws.observed_gumbel(frame_counter, shapes, sampling.OBSERVED_NUM_POINTS)
                if has_fields:
                    iteration_draws = draws.multi_view(frame_counter, num_iters, shapes)
    if not single_view:
        with profiling.span("ngm.frame.observed"):
            if graphs is None:
                observed = observed_fields(fset, camera, rgbd[..., 3], c2w, map_positions, allocated_mask,
                                           observed_gumbel, generator)
            else:
                maps = (params, adam, training_iterations, map_positions, map_orientations, cache)
                observed = graphs.observed(camera, maps, rgbd[..., 3], c2w, allocated_mask, observed_gumbel)
    loss_dict = {}
    if has_fields:
        scan = optimization_iterations_scan_sv if single_view else optimization_iterations_scan
        masks = (active_mask,) if single_view else (allocated_mask, observed)
        params, adam, training_iterations, loss_dict = scan(
            fset, camera, rcfg, ocfg, loss_cfg, num_train_fields, num_iters, params, adam, training_iterations,
            map_positions, map_orientations, *masks, *cache, generator, shard, iteration_draws, graphs,
        )
    return params, adam, training_iterations, cache_rgb, cache_depth, observed, loss_dict


def allocate_fields_jit(
    camera,
    field_radius: float,
    max_new: int,
    depth_image: torch.Tensor,
    c2w: torch.Tensor,
    active_positions: torch.Tensor,
    active_mask: torch.Tensor,
    shift: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Uncovered-cell field allocation for one depth image (name kept from
    the JAX package, where it is jitted) -> (centers, num_new, bb_min, bb_max)."""
    points_cam, _, valid = camera.depth_to_points_full(depth_image, "opengl")
    points_world = transforms.transform_points(points_cam, c2w)
    points_world = torch.where(valid[:, None], points_world, torch.zeros_like(points_world))
    centers, num_new = map_state.uncovered_cells(
        points_world, valid, active_positions, active_mask, field_radius, max_new,
        shift=shift, generator=generator,
    )
    inf = torch.full_like(points_world, torch.inf)
    bb_min = torch.amin(torch.where(valid[:, None], points_world, inf), dim=0)
    bb_max = torch.amax(torch.where(valid[:, None], points_world, -inf), dim=0)
    return centers, num_new, bb_min, bb_max


def span_sample_distances(
    t0: torch.Tensor,  # (B,) per-ray span start
    t1: torch.Tensor,  # (B,) per-ray span end
    u: torch.Tensor,  # (B, S) stratification jitter in [0, 1)
    sample_spacing: float,
) -> torch.Tensor:
    """Stratified sample distances of the span-restricted render path
    (B, S). With ``sample_spacing > 0`` samples step from t0 at that
    spacing, stretched to span / S only where the span outruns S samples;
    with 0, a dense stratification of [t0, t1]."""
    num_samples = u.shape[-1]
    if sample_spacing > 0.0:
        per_ray = torch.clamp((t1 - t0) / num_samples, min=sample_spacing)  # (B,)
        steps = torch.arange(num_samples, dtype=torch.float32, device=u.device)
        return t0[:, None] + (steps[None, :] + u) * per_ray[:, None]
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=u.device)[:-1]
    return t0[:, None] + (t1 - t0)[:, None] * (edges + u / num_samples)


def render_block_tiled(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    num_samples: int,
    near: float,
    far: float,
    params: dict,
    positions: torch.Tensor,  # (N, 3)
    orientations: torch.Tensor,  # (N, 4)
    allocated_mask: torch.Tensor,  # (N,) bool
    ijs: torch.Tensor,  # (B, 2) float (row, column)
    c2w: torch.Tensor,  # (4, 4)
    u: Optional[torch.Tensor] = None,  # (B, S) jitter; None = draw from generator
    generator: Optional[torch.Generator] = None,
    use_ray_kernel: bool = False,
    block_offset: Optional[int] = None,  # index of ijs[0] in the row-major grid
    sample_spacing: float = 0.0,
    shard: Optional[sharding.FieldGroup] = None,
):
    """One span-restricted render block through the tiled KNN path
    (engine.render_block_tiled_jit) -> (rgbd (B, 4), depth_vars (B,),
    term_probs (B,)).

    Per ray, samples start where the ray first enters an allocated field
    sphere (``span_sample_distances``); every (sample, neighbour) pair is
    evaluated by ``NeuralFieldSet.apply_knn_tiled`` and composited by
    ``quadrature``. With ``use_ray_kernel`` (k * S a power of two, ``ijs``
    the row-major pixel grid from ``block_offset``) the MoE kernel rebuilds
    each sample point from its pair index and distance. No host sync. With
    ``shard``, ``params`` are this rank's rows and the blend goes through
    ``sharding.render_points_sharded`` (one all-reduce).
    """
    with profiling.span("ngm.render.span"):
        b = ijs.shape[0]
        dirs = camera.ijs_to_directions(ijs)  # (B, 3) camera frame
        rot = c2w[:3, :3]
        origin = c2w[:3, 3]
        dirs_w = dirs @ rot.T  # (B, 3) world

        # per-ray span over the allocated field spheres
        co = positions - origin[None, :]  # (N, 3)
        proj = dirs_w @ co.T  # (B, N)
        c_sq = torch.sum(co * co, dim=-1)  # (N,)
        r = float(fset.field_radius)
        disc = proj * proj - (c_sq[None, :] - r * r)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        enter = proj - sq
        exit_ = proj + sq
        hit = (disc > 0.0) & allocated_mask[None, :] & (exit_ > near) & (enter < far)
        enter_c = torch.clamp(enter, near, far)
        exit_c = torch.clamp(exit_, near, far)
        t0 = torch.amin(torch.where(hit, enter_c, far), dim=-1)  # (B,)
        t1 = torch.amax(torch.where(hit, exit_c, near), dim=-1)
        any_hit = torch.any(hit, dim=-1)
        t0 = torch.where(any_hit, t0, near)
        t1 = torch.where(any_hit, torch.maximum(t1, t0), far)

        if u is None:
            u = torch.rand((b, num_samples), generator=generator, device=ijs.device)
        distances = span_sample_distances(t0, t1, u, sample_spacing)  # (B, S)
        points_world = origin[None, None, :] + dirs_w[:, None, :] * distances[..., None]

        ray_ctx = None
        if use_ray_kernel:
            ks = fset.num_knn * num_samples
            log2_ks = ks.bit_length() - 1
            if (1 << log2_ks) != ks or block_offset is None:
                raise ValueError("the ray kernel needs a power-of-two k * S and a block_offset")
            fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.0)
            # a non-blocking copy: a blocking one would wait for the device
            intr = torch.tensor([1.0 / fx, 1.0 / fy, cx, cy], dtype=torch.float32).to(
                c2w.device, non_blocking=True
            )
            ray_ctx = {
                "dist": distances.reshape(-1),
                "ray_params": torch.cat([rot.reshape(-1), origin, intr]).contiguous(),
                "block_offset": int(block_offset),
                "log2_ks": log2_ks,
                "width": int(camera.width),
            }

    if shard is None:
        outs = fset.apply_knn_tiled(
            params, points_world.reshape(-1, 3), positions, orientations, allocated_mask,
            ray_ctx=ray_ctx,
        )
    else:
        outs = sharding.render_points_sharded(
            fset, params, positions, orientations, allocated_mask, points_world.reshape(-1, 3), shard,
            ray_ctx=ray_ctx,
        )
    with profiling.span("ngm.render.composite"):
        outs = outs.reshape(b, num_samples, -1)

        sample_colors = rcfg.color_factor * outs[..., :3]
        sample_geometries = outs[..., 3]
        # depth = -z in the camera frame = distance * (-dir_z); dirs are unit
        sample_depths = distances * (-dirs[:, 2])[:, None]
        neus_isds = None
        if rcfg.geometry_mode == "neus":
            mean_sd = (torch.mean(params["neus_sd"]) if shard is None
                       else sharding.field_mean(params["neus_sd"], shard, positions.shape[0]))
            neus_isds = 1.0 / torch.abs(mean_sd)
        q = quad_mod.quadrature(
            rcfg.geometry_mode, sample_colors, sample_geometries, distances, sample_depths,
            geometry_factor=rcfg.geometry_factor, neus_isds=neus_isds,
        )
        rgbd = torch.cat([q.colors, q.depths[..., None]], dim=-1)
    return rgbd, q.depth_vars, q.term_probs


def _bin_edges(num_samples: int, device) -> torch.Tensor:
    """i * (1 / S) for i < S in f32: the first S of ``jnp.linspace(0, 1,
    S + 1)`` bit for bit (torch.linspace rounds its values differently)."""
    return torch.arange(num_samples, dtype=torch.float32, device=device) * (1.0 / num_samples)


def render_demand_probe(
    fset: NeuralFieldSet,
    camera,
    num_samples: int,
    near: float,
    far: float,
    positions: torch.Tensor,  # (N, 3)
    allocated_mask: torch.Tensor,  # (N,)
    ijs: torch.Tensor,  # (B, 2)
    c2w: torch.Tensor,  # (4, 4)
) -> torch.Tensor:
    """The most (sample, neighbour) pairs any field gets in one render block
    at bin-centre samples -> 0-d int64 tensor; ``render_image`` sizes the
    capacity route's buffer from it. (JAX's takes the params too, unused.)"""
    dirs = camera.ijs_to_directions(ijs)
    edges = _bin_edges(num_samples, ijs.device)
    distances = near + (far - near) * (edges + 0.5 / num_samples)
    points = (dirs[:, None, :] * distances[None, :, None]).reshape(-1, 3)
    points_world = transforms.transform_points(points, c2w)
    k = fset.num_knn
    knn_dists, knn_idx = dispatch.topk_fields(points_world, positions, allocated_mask, k)
    inside = knn_dists[:, 0] < fset.field_radius
    pair_valid = torch.repeat_interleave(inside, k) & torch.isfinite(knn_dists.reshape(-1))
    n_cap = positions.shape[0]
    ids = torch.where(pair_valid, knn_idx.reshape(-1).long(), n_cap)
    counts = torch.zeros(n_cap + 1, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, ids, torch.ones_like(ids))
    return torch.max(counts[:n_cap])


def render_block(
    fset: NeuralFieldSet,
    camera,
    rcfg: render.RenderConfig,
    num_samples: int,
    near: float,
    far: float,
    capacity: int,
    params: dict,
    positions: torch.Tensor,  # (N, 3)
    orientations: torch.Tensor,  # (N, 4)
    allocated_mask: torch.Tensor,  # (N,) bool
    ijs: torch.Tensor,  # (B, 2) float (row, column)
    c2w: torch.Tensor,  # (4, 4)
    u: Optional[torch.Tensor] = None,  # (B, S) jitter; None = draw from generator
    generator: Optional[torch.Generator] = None,
):
    """One render block through the capacity-buffer route
    (engine.render_block_jit) -> (rgbd (B, 4), depth_vars (B,), term_probs
    (B,), dropped pairs (0-d tensor)).

    A stratified sweep of [near, far] at ``num_samples`` samples a ray
    (jitter ``u``), every sample blended from its k nearest fields by
    :meth:`NeuralFieldSet.apply_knn` with ``capacity`` slots a field
    (pairs past it are dropped and counted), composited by ``quadrature``
    with the fields' mean inverse SD for ``neus``. No host sync.
    """
    b = ijs.shape[0]
    dirs = camera.ijs_to_directions(ijs)
    edges = _bin_edges(num_samples, ijs.device)
    if u is None:
        u = torch.rand((b, num_samples), generator=generator, device=ijs.device)
    distances = near + (far - near) * (edges + u / num_samples)  # (B, S)
    points_cam = dirs[:, None, :] * distances[..., None]
    points_world = transforms.transform_points(points_cam, c2w)
    outs, dropped = fset.apply_knn(
        params, points_world.reshape(-1, 3), positions, orientations, allocated_mask,
        capacity=capacity, with_stats=True,
    )
    outs = outs.reshape(b, num_samples, -1)
    sample_colors = rcfg.color_factor * outs[..., :3]
    sample_geometries = outs[..., 3]
    sample_depths = -points_cam[..., 2]
    neus_isds = None
    if rcfg.geometry_mode == "neus":
        neus_isds = 1.0 / torch.abs(torch.mean(params["neus_sd"]))
    q = quad_mod.quadrature(
        rcfg.geometry_mode, sample_colors, sample_geometries, distances, sample_depths,
        geometry_factor=rcfg.geometry_factor, neus_isds=neus_isds,
    )
    rgbd = torch.cat([q.colors, q.depths[..., None]], dim=-1)
    return rgbd, q.depth_vars, q.term_probs, dropped


class NeuralGraphMap:
    """Online neural graph mapping on one device, or with the field axis
    split over the ranks of a process group.

    Construct from a config dict, and drive :meth:`process_frame` per frame.
    The map lives on ``device``: the card unless the caller asks for the
    CPU; without CUDA the default raises, it never falls back to the CPU.
    With ``num_field_shards: W > 1`` in the config, every rank of a group
    of W builds the map and calls every method in the same order (each
    holds its rows of the field state; see the module docstring); ``group``
    is the ``sharding.FieldGroup``, else the default process group, which
    must have W ranks.
    """

    def __init__(
        self, config: dict, device="cuda", group: Optional[sharding.FieldGroup] = None,
        draws: Optional[DrawSource] = None,
    ) -> None:
        if device is None:
            raise ValueError("NeuralGraphMap needs a device: 'cuda' (the default) or 'cpu'")
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"NeuralGraphMap runs on {self._device} unless device='cpu' is given, "
                "and CUDA is not available"
            )
        # every random draw from this source instead of the generators
        self._draws = draws
        self._read_config(config)
        self._init_model()
        self._init_state(group)

    # -- configuration ---------------------------------------------------------

    def _read_config(self, config: dict) -> None:
        c = dict(config)
        self._config = c
        self._model_kwargs = c["model_kwargs"]
        self._field_radius = float(c.get("field_radius", 1.0))
        self._update_mode = c.get("update_mode", "multi_view")
        if self._update_mode not in ("multi_view", "single_view"):
            # the JAX engine trains nothing for an unknown mode
            raise ValueError(
                f"update_mode must be 'multi_view' or 'single_view', got {self._update_mode!r}"
            )
        self._num_iterations_per_frame = int(c.get("num_iterations_per_frame", 5))
        self._keyframes_only = bool(c.get("keyframes_only", False))
        self._max_depth = c.get("max_depth", None)
        self._disable_relative_fields = bool(c.get("disable_relative_fields", False))
        self._num_kf_slots = int(c.get("num_kf_slots", 1000))
        self._max_new_fields = int(c.get("max_new_fields", 256))
        self._active_max_edges = int(c.get("active_max_edges", 100))

        trunc = c.get("truncation_distance", 0.1)
        range_guided = c.get("range_depth_guided", None)
        if range_guided is None:
            range_guided = trunc
        self._rcfg = render.RenderConfig(
            geometry_mode=c.get("geometry_mode", "nrgbd"),
            geometry_factor=float(c.get("geometry_factor", 20.0)),
            color_factor=float(c.get("color_factor", 1.0)),
            num_samples_coarse=int(c.get("num_samples_coarse", 8)),
            num_samples_depth_guided=int(c.get("num_samples_depth_guided", 16)),
            range_depth_guided=float(range_guided),
            truncation_distance=float(trunc),
        )
        self._ocfg = optimizer.AdamConfig(
            learning_rate=float(c.get("learning_rate", 1e-3)),
            eps=float(c.get("adam_eps", 1e-15)),
            weight_decay=float(c.get("adam_weight_decay", 0.0)),
        )
        self._loss_cfg = LossConfig(
            termination_weight=float(c.get("termination_weight", 0.0)),
            photometric_weight=float(c.get("photometric_weight", 1.0)),
            photometric_loss=c.get("photometric_loss", "l1"),
            depth_weight=float(c.get("depth_weight", 1.0)),
            depth_loss=c.get("depth_loss", "huber"),
            freespace_weight=float(c.get("freespace_weight", 40.0)),
            tsdf_weight=float(c.get("tsdf_weight", 50.0)),
            num_rays_per_field=int(c.get("num_rays_per_field", 512)),
            single_field_id=(
                int(c["single_field_id"]) if c.get("single_field_id") is not None else None
            ),
        )
        self._num_train_fields = int(c.get("num_train_fields", 32))
        self._eval_near = float(c.get("eval_near_distance", 0.0))
        self._eval_far = float(c.get("eval_far_distance", 8.0))
        # eval sample spacing = the train-time depth-guided spacing
        # (2 * range / guided samples), else the coarse field-diameter one
        if self._rcfg.num_samples_depth_guided > 0:
            self._sample_spacing = (
                2 * self._rcfg.range_depth_guided / self._rcfg.num_samples_depth_guided
            )
        else:
            self._sample_spacing = 2 * self._field_radius / self._rcfg.num_samples_coarse
        self._eval_num_samples = int(
            c.get("eval_num_samples", (self._eval_far - self._eval_near) / self._sample_spacing)
        )
        # samples per ray of the span-restricted render path
        self._eval_span_samples = int(
            min(self._eval_num_samples, int(c.get("eval_span_samples", 512)))
        )
        self._pixel_block_size = int(c.get("pixel_block_size", 8192))
        self._seed = int(c.get("seed", 0))
        # the fused encode + MLP training route (JAX: NGM_FUSED_MLP=1); a
        # top-level key, so one config file still drives both packages
        self._fused_mlp = c.get("fused_mlp", False)
        if not isinstance(self._fused_mlp, bool):
            raise ValueError(f"fused_mlp must be true or false, got {self._fused_mlp!r}")
        self._num_field_shards = int(c.get("num_field_shards", 1))
        if self._num_field_shards < 1:
            raise ValueError(f"num_field_shards must be >= 1, got {self._num_field_shards}")

    def _init_model(self) -> None:
        kwargs = dict(self._model_kwargs)
        kwargs["field_kwargs"] = {**kwargs["field_kwargs"], "fused_mlp": self._fused_mlp}
        self._fset = NeuralFieldSet(**kwargs).to(self._device)
        # two streams of draws, as the JAX engine has two keys: one for
        # parameter init and renders (JAX's _key), one for the per-frame
        # programs (_base_key), so a render between frames leaves every
        # later training draw where it was
        self._init_gen = torch.Generator(self._device).manual_seed(self._seed)
        self._frame_gen = torch.Generator(self._device).manual_seed(self._seed + 1)
        self._frame_counter = 0

    @property
    def _step_generator(self) -> Optional[torch.Generator]:
        """The generator the frame step draws from, eager or graphed: none
        under a DrawSource, which gives every draw; else, as the JAX engine's
        keys, ``_init_gen`` in single view (JAX feeds its single-view scan
        from ``_next_key()``) and ``_frame_gen`` in multi-view."""
        if self._draws is not None:
            return None
        return self._init_gen if self._update_mode == "single_view" else self._frame_gen

    def _frame_graphs(self):
        """The frame step's CUDA graphs (:mod:`frame_graphs`), or None where
        the map trains eagerly: on the CPU, sharded, on the ``fused_mlp``
        route, with fields the encode cut does not take."""
        from neural_graph_mapping_tpu_torch.mapping import frame_graphs

        gen = self._step_generator
        if not frame_graphs.supported(self._fset, self._device, self._shard, gen):
            return None
        return frame_graphs.FrameGraphs(self._fset, self._rcfg, self._ocfg, self._loss_cfg, gen, self._device)

    def _field_group(self, group: Optional[sharding.FieldGroup]) -> Optional[sharding.FieldGroup]:
        """The group the field axis is split over, None unsharded."""
        import torch.distributed as dist

        w = self._num_field_shards
        if w == 1:
            return None
        if group is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"num_field_shards={w} needs a process group of {w} ranks: launch with "
                    f"torchrun --nproc_per_node={w} (run_mapping --dist-backend nccl|gloo), or pass "
                    "group=sharding.make_field_group(...)"
                )
            group = sharding.FieldGroup(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
        if group.size != w:
            raise RuntimeError(
                f"num_field_shards={w} but the process group has {group.size} ranks: launch with "
                f"torchrun --nproc_per_node={w}"
            )
        return group

    def _init_state(self, group: Optional[sharding.FieldGroup] = None) -> None:
        cap = 32
        if cap % self._num_field_shards != 0:
            raise ValueError(
                f"field capacity {cap} must be divisible by num_field_shards={self._num_field_shards}"
            )
        self._shard = self._field_group(group)
        dev = self._device
        self._map_arrays = map_state.init_map_arrays(cap, dev)
        self._params = self._own_rows(self._new_fields(cap))
        self._adam = optimizer.init_adam_state(self._params)
        self._graphs = self._frame_graphs()
        self._num_fields = 0
        # the capacity route's full copy of a sharded map, during one render
        self._gathered_params: Optional[dict] = None

        self._graph: Dict[int, Set[int]] = {}
        self._kf2fields: Dict[int, Set[int]] = {}
        self._kf_ids: Set[int] = set()
        self._last_update: Optional[int] = None
        self._prev_kf2w_slots: Optional[np.ndarray] = None

        # keyframe cache; slot 0 = current frame
        self._camera = None  # the dataset's, from the first frame on
        self._cache_rgb = None  # allocated lazily once H, W known
        self._cache_depth = None
        self._cache_c2w_np = np.tile(np.eye(4, dtype=np.float32), (self._num_kf_slots, 1, 1))
        self._cache_valid_np = np.zeros((self._num_kf_slots,), bool)
        self._free_slots = list(range(1, self._num_kf_slots))
        self._frame_to_slot: Dict[int, int] = {}
        # device mirrors of the host-side cache bookkeeping, re-uploaded only
        # when written
        self._cache_c2w_dev = None
        self._cache_valid_dev = None
        self._cache_c2w_dirty = True
        self._cache_valid_dirty = True
        self._last_graph_obj = None
        self._pending_slot_poses: Optional[np.ndarray] = None

        self._observed_mask = None
        self._bb_min = np.full((3,), np.inf, np.float32)
        self._bb_max = np.full((3,), -np.inf, np.float32)
        # per-frame host phase accounting (seconds, cumulative)
        self.phase_times: Dict[str, float] = {}
        self.throughput = profiling.ThroughputTracker()
        # the last render_image's route, and on the capacity route its
        # buffer size, the probe's demand and the pairs it dropped
        self.render_stats: Dict[str, object] = {}

    # -- capacity management ----------------------------------------------------

    @property
    def num_fields(self) -> int:
        return self._num_fields

    @property
    def capacity(self) -> int:
        return map_state.capacity(self._map_arrays)

    def _ensure_capacity(self, required: int) -> None:
        cap = self.capacity
        if required <= cap:
            return
        new_cap = cap
        while new_cap < required:
            new_cap *= 2
        logger.info("growing field capacity %d -> %d", cap, new_cap)
        self._map_arrays = map_state.grow_capacity(self._map_arrays, new_cap)
        # every rank draws the whole block, so the init stream stays in step
        extra = self._own_rows(self._new_fields(new_cap - cap))
        self._params = {k: torch.cat([v, extra[k]]) for k, v in self._params.items()}
        self._adam = optimizer.grow_adam_state(self._adam, self._params)

    def _new_fields(self, num_fields: int) -> dict:
        """Stacked initial parameters of ``num_fields`` fields, all ranks'."""
        if self._draws is not None:
            return self._draws.init_fields(num_fields)
        return self._fset.init_fields(num_fields, self._init_gen, self._device)

    def _draw_shapes(self) -> DrawShapes:
        return draw_shapes(self._rcfg, self._loss_cfg, self._num_train_fields, self._map_arrays.positions,
                           self._cache_depth)

    def _own_rows(self, tree: dict) -> dict:
        """This rank's rows of a full stacked-field dict (all of it unsharded)."""
        return tree if self._shard is None else sharding.shard_field_tensors(tree, self._shard)

    @property
    def shard(self) -> Optional[sharding.FieldGroup]:
        """The field axis's process group, None unsharded."""
        return self._shard

    def full_params(self) -> dict:
        """The stacked params of every field in global order (sharded: an
        all_gather, so every rank must call it)."""
        return self._params if self._shard is None else sharding.gather_field_tensors(self._params, self._shard)

    def full_adam(self) -> optimizer.AdamState:
        """The Adam state of every field in global order (sharded: collective)."""
        if self._shard is None:
            return self._adam
        gathered = sharding.gather_field_tensors(
            {**{f"m.{k}": v for k, v in self._adam.m.items()}, **{f"v.{k}": v for k, v in self._adam.v.items()},
             "steps": self._adam.steps},
            self._shard,
        )
        return optimizer.AdamState(
            m={k: gathered[f"m.{k}"] for k in self._adam.m},
            v={k: gathered[f"v.{k}"] for k in self._adam.v},
            steps=gathered["steps"],
        )

    def _allocated_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self._device) < self._num_fields

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self._device)

    def _upload(self, x: np.ndarray, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A host array to the device (into ``out`` where given). On a card
        it goes up from pinned memory without blocking: a copy from pageable
        memory would wait for the frame's queued work."""
        host = torch.from_numpy(np.array(x))  # a copy: the host array changes later
        if self._device.type == "cuda":
            host = host.pin_memory()
        if out is None or out.shape != host.shape:
            return host.to(self._device, non_blocking=True)
        return out.copy_(host, non_blocking=True)

    # -- per-frame pipeline ------------------------------------------------------

    def _init_cache(self, h: int, w: int) -> None:
        s = self._num_kf_slots
        self._cache_rgb = torch.zeros((s, h, w, 3), dtype=torch.bfloat16, device=self._device)
        self._cache_depth = torch.zeros((s, h, w), dtype=torch.float32, device=self._device)

    def _update_graph(self, dataset, frame_id: int) -> None:
        """Pose-graph update + keyframe removal handling; the graph copy runs
        only when the dataset hands over a different graph object, the pose
        snapshot only when poses may have moved or keyframes were removed."""
        new_graph = dataset.get_slam_essential_graph(frame_id)

        if self._last_update is None:
            self._graph = {k: set(v) for k, v in new_graph.items()}
            self._last_graph_obj = new_graph
            self._last_update = frame_id
            self._prev_kf2w_slots = self._snapshot_kf_slot_poses(dataset, frame_id)
            self._pending_slot_poses = None
            return

        poses_dirty = dataset.slam_poses_dirty(frame_id)
        graph_changed = new_graph is not self._last_graph_obj

        removed: Set[int] = set()
        if graph_changed:
            prev_kfs = set(self._kf_ids)
            removed = prev_kfs - set(new_graph.keys())
            surviving = prev_kfs - removed
            if dataset.is_keyframe(frame_id):
                surviving.add(frame_id)

            kf_ids_np = kf_slots_np = None
            if removed:  # device->host pulls only when keyframes disappeared
                kf_ids_np = self._map_arrays.kf_ids.cpu().numpy().copy()
                kf_slots_np = self._map_arrays.kf_slots.cpu().numpy().copy()
            dirty = False
            for kf in sorted(removed):
                self._kf_ids.discard(kf)
                slot = self._frame_to_slot.pop(kf, None)
                if slot is not None:
                    self._free_slots.append(slot)
                    self._cache_valid_np[slot] = False
                    self._cache_valid_dirty = True
                # re-anchor fields to the nearest surviving keyframe
                after = min((i for i in surviving if i >= kf), default=None)
                before = max((i for i in surviving if i <= kf), default=None)
                new_anchor = after if (after is not None and after in prev_kfs) else before
                if new_anchor is None:
                    continue
                if kf in self._kf2fields:
                    self._kf2fields.setdefault(new_anchor, set()).update(self._kf2fields.pop(kf))
                mask = kf_ids_np == kf
                if mask.any():
                    kf_ids_np[mask] = new_anchor
                    kf_slots_np[mask] = self._frame_to_slot.get(new_anchor, 0)
                    dirty = True
            if dirty:  # in place: the frame step's graphs hold the map's tensors
                self._map_arrays.kf_ids.copy_(torch.from_numpy(kf_ids_np))
                self._map_arrays.kf_slots.copy_(torch.from_numpy(kf_slots_np))

        # loop-closure deformation against the previous frame's slot poses
        self._pending_slot_poses = None
        if poses_dirty or removed:
            new_slot_poses = self._snapshot_kf_slot_poses(dataset, frame_id)
            self._pending_slot_poses = new_slot_poses  # reused after kf registration
            if (
                not self._disable_relative_fields
                and self._num_fields > 0
                and not np.array_equal(new_slot_poses, self._prev_kf2w_slots)
            ):
                moved = map_state.reanchor_field_poses(
                    self._map_arrays,
                    self._to_device(self._prev_kf2w_slots),
                    self._to_device(new_slot_poses),
                )
                self._map_arrays.positions.copy_(moved.positions)
                self._map_arrays.orientations.copy_(moved.orientations)
        if graph_changed:
            self._graph = {k: set(v) for k, v in new_graph.items()}
            self._last_graph_obj = new_graph
        self._last_update = frame_id

    def _snapshot_kf_slot_poses(self, dataset, at_frame_id: int) -> np.ndarray:
        """Per-slot keyframe poses at a given frame (identity for free slots)."""
        poses = np.tile(np.eye(4, dtype=np.float32), (self._num_kf_slots, 1, 1))
        for kf, slot in self._frame_to_slot.items():
            c2w = np.asarray(dataset.get_slam_c2ws(kf, at_frame_id))
            if np.isfinite(c2w).all():
                poses[slot] = c2w
        return poses

    def _active_field_ids(self, frame_id: int) -> np.ndarray:
        """Fields of keyframes within BFS distance of the closest keyframe."""
        kfs = [k for k in self._graph.keys() if k <= frame_id]
        if not kfs:
            return np.zeros((0,), np.int64)
        neighbors = graph_mod.get_neighbors(
            self._graph, {max(kfs)}, max_edges=self._active_max_edges, include_queries=True
        )
        ids: Set[int] = set()
        for kf in neighbors:
            ids |= self._kf2fields.get(kf, set())
        return np.fromiter(ids, np.int64) if ids else np.zeros((0,), np.int64)

    def _active_mask(self, frame_id: int) -> torch.Tensor:
        """(capacity,) mask of :meth:`_active_field_ids` on the device
        (:meth:`_upload`)."""
        mask = np.zeros((self.capacity,), bool)
        mask[self._active_field_ids(frame_id)] = True
        return self._upload(mask)

    def process_frame(self, dataset, frame_id: int, rgbd) -> dict:
        """Ingest one frame (H, W, 4 RGB-D) and run the per-frame
        optimization. ``rgbd`` is a numpy array (uploaded here) or a float32
        tensor already on the map's device (used as it is, no copy, as the
        CLI's prefetcher hands it over). Returns the last iteration's losses
        as floats (one device sync per frame)."""
        with profiling.span("ngm.frame.process", frame=frame_id):
            return self._process_frame(dataset, frame_id, rgbd)

    def _process_frame(self, dataset, frame_id: int, rgbd) -> dict:
        t_start = time.time()
        self._frame_counter += 1
        rgbd = self._to_device(rgbd).float()
        h, w = rgbd.shape[0], rgbd.shape[1]
        if self._cache_rgb is None:
            self._init_cache(h, w)
        if self._camera is None:  # a loaded full checkpoint brings its cache
            self._camera = dataset.camera

        if self._max_depth is not None:
            depth = rgbd[..., 3]
            rgbd = rgbd.clone()
            rgbd[..., 3] = torch.where(depth > self._max_depth, torch.zeros_like(depth), depth)

        c2w_np = np.asarray(dataset.get_slam_c2ws(frame_id), dtype=np.float32)
        c2w_missing = not np.isfinite(c2w_np).all()
        c2w = self._upload(c2w_np if not c2w_missing else np.eye(4, dtype=np.float32))

        with profiling.phase("graph", into=self.phase_times):
            self._update_graph(dataset, frame_id)

        with profiling.phase("alloc", into=self.phase_times):
            is_kf = dataset.is_keyframe(frame_id)
            kf_slot = -1
            if is_kf:
                self._kf_ids.add(frame_id)
                if not self._free_slots:
                    raise ValueError("Maximum number of keyframes reached.")
                kf_slot = self._free_slots.pop(0)
                self._frame_to_slot[frame_id] = kf_slot
                self._cache_valid_np[kf_slot] = True
                self._cache_valid_dirty = True
                if not c2w_missing:
                    self._allocate_new_fields(frame_id, rgbd[..., 3], c2w, kf_slot)

        with profiling.phase("host_misc", into=self.phase_times):
            allocated = self._host_misc(is_kf, kf_slot, c2w_np, c2w_missing)
        write_current = not self._keyframes_only and not c2w_missing

        with profiling.span("ngm.frame.step", frame=frame_id):
            loss_dict = self._frame_step(frame_id, rgbd, c2w, kf_slot, write_current, allocated)
            losses = {}
            if loss_dict:
                with profiling.span("ngm.frame.sync", frame=frame_id):
                    values = torch.stack(list(loss_dict.values())).tolist()
                losses = dict(zip(loss_dict.keys(), values))
        # the frame's time ends after the losses' copy, which waits for the
        # device: the JAX engine stops its clock before that wait
        self.throughput.add_frame(time.time() - t_start)
        return losses

    def _host_misc(self, is_kf: bool, kf_slot: int, c2w_np, c2w_missing: bool) -> torch.Tensor:
        """The current frame's and the keyframe slots' poses and validity to
        the device -> the allocated-field mask."""
        # current frame occupies slot 0
        if not self._keyframes_only:
            if bool(self._cache_valid_np[0]) != (not c2w_missing):
                self._cache_valid_np[0] = not c2w_missing
                self._cache_valid_dirty = True
            if not c2w_missing:
                self._cache_c2w_np[0] = c2w_np
                self._cache_c2w_dirty = True

        # refresh slot poses after keyframe registration; kept as the prev
        # snapshot for the next frame's re-anchoring
        if self._pending_slot_poses is not None:
            snap = self._pending_slot_poses
            self._pending_slot_poses = None
            if is_kf and not c2w_missing:
                snap[kf_slot] = c2w_np
            self._prev_kf2w_slots = snap
            self._cache_c2w_np[1:] = snap[1:]
            self._cache_c2w_dirty = True
        elif is_kf and not c2w_missing:
            self._prev_kf2w_slots[kf_slot] = c2w_np
            self._cache_c2w_np[kf_slot] = c2w_np
            self._cache_c2w_dirty = True

        # in place: the frame step's graphs read these tensors
        if self._cache_c2w_dirty or self._cache_c2w_dev is None:
            self._cache_c2w_dev = self._upload(self._cache_c2w_np, self._cache_c2w_dev)
            self._cache_c2w_dirty = False
        if self._cache_valid_dirty or self._cache_valid_dev is None:
            self._cache_valid_dev = self._upload(self._cache_valid_np, self._cache_valid_dev)
            self._cache_valid_dirty = False
        return self._allocated_mask()

    def _frame_step(self, frame_id: int, rgbd, c2w, kf_slot: int, write_current: bool,
                    allocated: torch.Tensor) -> dict:
        """The frame's device program, :func:`frame_step`, whose observed
        test and iterations replay from ``self._graphs`` where the map has
        graphs (None: eagerly) -> the last iteration's loss dict."""
        active = self._active_mask(frame_id) if self._update_mode == "single_view" else None
        # the training counts, cache and map change in place
        self._params, self._adam, _, _, _, self._observed_mask, loss_dict = frame_step(
            self._fset, self._camera, self._rcfg, self._ocfg, self._loss_cfg, self._num_train_fields,
            self._num_iterations_per_frame, write_current, self._num_fields > 0, self._params, self._adam,
            self._map_arrays.training_iterations, self._map_arrays.positions, self._map_arrays.orientations,
            allocated, self._cache_rgb, self._cache_depth, self._cache_c2w_dev, self._cache_valid_dev, rgbd, c2w,
            kf_slot, self._step_generator, self._shard, self._draws, self._frame_counter, active, self._graphs,
        )
        return loss_dict

    def _allocate_new_fields(self, frame_id, depth, c2w, kf_slot) -> None:
        active_ids = self._active_field_ids(frame_id)
        active_mask_np = np.zeros((self.capacity,), bool)
        if self._num_fields > 0:
            active_mask_np[active_ids] = True
        centers, num_new, bb_min, bb_max = allocate_fields_jit(
            self._camera,
            self._field_radius,
            self._max_new_fields,
            depth,
            c2w,
            self._map_arrays.positions,
            self._to_device(active_mask_np),
            shift=None if self._draws is None else self._draws.allocation_shift(self._frame_counter),
            generator=self._frame_gen,
        )
        n_new = int(num_new)  # host needs the count: one sync per keyframe
        self._bb_min = np.minimum(self._bb_min, bb_min.cpu().numpy())
        self._bb_max = np.maximum(self._bb_max, bb_max.cpu().numpy())
        if n_new == 0:
            return
        self._ensure_capacity(self._num_fields + n_new)
        self._map_arrays = map_state.append_fields(
            self._map_arrays, self._num_fields, centers, n_new, frame_id, kf_slot
        )
        self._kf2fields.setdefault(frame_id, set()).update(
            range(self._num_fields, self._num_fields + n_new)
        )
        self._num_fields += n_new

    # -- throughput accounting ---------------------------------------------------

    @property
    def fps_estimate(self) -> float:
        return self.throughput.fps_estimate

    @property
    def spf_estimate(self) -> float:
        return self.throughput.spf_estimate

    # -- rendering ---------------------------------------------------------------

    def render_block_size(self) -> int:
        """Rays per render block: ``pixel_block_size``, shrunk in proportion
        for spans above 512 samples so a block's sample count stays put."""
        block = self._pixel_block_size
        if self._eval_span_samples > 512:
            block = max(1024, int(block * 512 / self._eval_span_samples))
        return block

    @profiling.benchmark
    def render_image(self, c2w, camera, capacity_per_field: Optional[int] = None):
        """Render an RGB-D image from pose ``c2w`` (4, 4) with ``camera``,
        block by block -> (rgbd (H, W, 4), depth_vars (H, W)).

        The tiled KNN route (span-restricted samples, no drops) serves every
        map whose fields it takes (``supports_tiled_knn``), on every device;
        its ray kernel runs when num_knn * eval_span_samples is a power of
        two, carried coordinates otherwise. The capacity-buffer route
        (``render_block``: a uniform [near, far] sweep at eval_num_samples)
        serves other fields and an explicit ``capacity_per_field``; without
        one, the buffer is sized from the first block's demand
        (``render_demand_probe``): 1 << max(13, ceil(log2(1.5 * max))),
        halved while it and the field capacity pass 2^25 slots. Dropped
        pairs are logged (``chunking.warn_dropped_pairs``). Both routes draw
        their jitter from the init stream. ``render_stats`` records the
        route, and on the capacity route the capacity, the probe's demand
        and the dropped pairs (one host sync at the end).
        A span ``ngm.render.image`` while tracing.
        """
        with profiling.span("ngm.render.image"):
            return self._render_image(c2w, camera, capacity_per_field)

    def _render_image(self, c2w, camera, capacity_per_field: Optional[int]):
        h, w = camera.height, camera.width
        dev = self._device
        ii, jj = torch.meshgrid(
            torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
        )
        ijs_all = torch.stack([ii, jj], dim=-1).reshape(-1, 2).to(torch.float32)
        c2w = self._to_device(c2w).to(torch.float32)
        if capacity_per_field is not None or not self._fset.supports_tiled_knn():
            return self._render_image_capacity(c2w, camera, ijs_all, capacity_per_field)
        self.render_stats = {"route": "tiled"}
        ks = self._fset.num_knn * self._eval_span_samples
        use_ray_kernel = (ks & (ks - 1)) == 0
        allocated = self._allocated_mask()
        block = self.render_block_size()

        def model(ijs, offset):
            with profiling.span("ngm.render.block", block=offset // block):
                rgbd, dv, _ = render_block_tiled(
                    self._fset, camera, self._rcfg, self._eval_span_samples, self._eval_near,
                    self._eval_far, self._params, self._map_arrays.positions,
                    self._map_arrays.orientations, allocated, ijs, c2w,
                    generator=self._init_gen, use_ray_kernel=use_ray_kernel, block_offset=offset,
                    sample_spacing=float(self._sample_spacing), shard=self._shard,
                )
            return rgbd, dv

        rgbds, depth_vars = chunking.batched_evaluation(model, ijs_all, block, pass_offset=True)
        return rgbds.reshape(h, w, 4), depth_vars.reshape(h, w)

    def _render_image_capacity(self, c2w, camera, ijs_all, capacity_per_field: Optional[int]):
        """render_image's capacity-buffer route (see there)."""
        h, w = camera.height, camera.width
        block = self.render_block_size()
        max_count = None
        if capacity_per_field is None:
            probe_ijs = ijs_all[:block]
            if probe_ijs.shape[0] < block:
                probe_ijs = torch.cat([probe_ijs, probe_ijs.new_zeros((block - probe_ijs.shape[0], 2))])
            max_count = int(render_demand_probe(
                self._fset, camera, self._eval_num_samples, self._eval_near, self._eval_far,
                self._map_arrays.positions, self._allocated_mask(), probe_ijs, c2w,
            ))
            capacity_per_field = 1 << max(13, math.ceil(math.log2(max(max_count, 1) * 1.5)))
            while capacity_per_field * self.capacity > (1 << 25) and capacity_per_field > 8192:
                capacity_per_field //= 2
            logger.info("render dispatch: max demand %d -> capacity %d", max_count, capacity_per_field)
        drop_counts = []

        def model(ijs, offset):
            with profiling.span("ngm.render.block", block=offset // block):
                rgbd, dv, _, dropped = self._render_ij_block(ijs, c2w, camera, capacity_per_field)
            drop_counts.append(dropped)
            return rgbd, dv

        if self._shard is not None:  # every rank evaluates the full copy, as XLA does for JAX's
            self._gathered_params = self.full_params()
        try:
            rgbds, depth_vars = chunking.batched_evaluation(model, ijs_all, block, pass_offset=True)
        finally:
            self._gathered_params = None
        dropped = chunking.warn_dropped_pairs(drop_counts, logger, "render", capacity_per_field)
        self.render_stats = {"route": "capacity", "capacity_per_field": capacity_per_field,
                             "probe_max_count": max_count, "dropped_pairs": dropped}
        return rgbds.reshape(h, w, 4), depth_vars.reshape(h, w)

    def _render_ij_block(self, ijs, c2w, camera, capacity_per_field: int):
        """One capacity-route block of the map (render_block), jitter from
        the init stream."""
        params = self._params if self._gathered_params is None else self._gathered_params
        return render_block(
            self._fset, camera, self._rcfg, self._eval_num_samples, self._eval_near,
            self._eval_far, capacity_per_field, params, self._map_arrays.positions,
            self._map_arrays.orientations, self._allocated_mask(), ijs, c2w,
            generator=self._init_gen,
        )
