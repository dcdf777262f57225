"""The frame step's device work replayed from CUDA graphs.

One training iteration of :mod:`engine` (``optimization_iteration`` or
``optimization_iteration_sv``, unsharded) launches some 750 kernels, and the
host's enqueue of them, not the device, set the pace of a trained frame.
Here each iteration is cut where it calls the hand-written encode kernels,
which stay eager Python calls (their shape-based routing, and what a caller
that wraps them sees, stay as they are); the stretches between them are
CUDA graphs, recorded once and replayed with one launch each:

- ``pre``: the targets (multi-view: field selection and
  ``sampling.sample_target_mv``; single view: the view and
  ``sampling.sample_target_sv``), the target fields' parameters and poses
  gathered, the ray samples and their field-local coordinates (F, 3, P);
- ``permuto_cuda.encode_fwd``, eager;
- ``post``: the MLP, compositing and the losses, and their backward down to
  the encoded features and the MLP weights, recorded with autograd in one
  graph;
- ``permuto_cuda.encode_bwd_table`` on that gradient, eager;
- ``adam``: ``optimizer.adam_slice_update`` and the training counts.

The replayed iteration calls the two encode entries itself, where the eager
one reaches them through autograd (``permuto._EncodeFused``): the same
calls, without autograd's engine, which would hand the backward to its
device thread and back each iteration. A multi-view frame's observed-field
test is a graph of its own.

Graphs read and write fixed tensors. The map's tensors (parameters, Adam
state, poses, training counts, keyframe cache) are updated in place, and
the frame's other inputs (the allocated mask, the observed or active mask,
the frame's depth and pose, a :class:`engine.DrawSource`'s draws, the
single-view parity, the encode's output and the table's gradient) are
copied into buffers of this object before each replay. The graphs belong
to a key: the address and shape of every map tensor they touch, which a
capacity growth or a loaded map changes. A new key drops them with their
memory; its first iteration (and observed test) runs eagerly, which warms
every kernel at the new shapes, and the next one records the graphs, whose
own first replay is that iteration's step, so no Adam step is ever applied
twice.

Generator draws are drawn inside the graphs: each graph that draws
registers the map's generator (``CUDAGraph.register_generator_state``), so
a replay draws from the generator where the eager step would have, and a
recording draws nothing. Captures run on a side stream of this object in
the thread-local capture mode, so that the frame prefetcher's thread may
allocate and copy while one is underway.

A recording launches nothing, and a replay calls no kernel wrapper: each
graph takes back what its recording added to ``permuto_cuda.LAUNCHES`` and
adds it again at every replay, so the counts stay those of the kernels run.
"""

from __future__ import annotations

import gc
from typing import NamedTuple, Optional

import torch

from neural_graph_mapping_tpu_torch.mapping import engine, optimizer, render, sampling
from neural_graph_mapping_tpu_torch.ops import permuto_cuda
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding
from neural_graph_mapping_tpu_torch.utils import profiling


def supported(fset, device: torch.device, shard, generator: Optional[torch.Generator]) -> bool:
    """Whether a map's frame step can run from graphs: on CUDA, unsharded
    (the sharded step reads its owned-target count on the host), through the
    fused permutohedral encode with no concatenated points (the cut), not
    the ``fused_mlp`` route, and, where the map draws from ``generator``,
    with a torch whose graphs take a generator of their own."""
    enc = getattr(fset.prototype, "encoding", None)
    return (
        device.type == "cuda"
        and shard is None
        and not getattr(fset.prototype, "fused_mlp", False)
        and isinstance(enc, PermutohedralEncoding)
        and enc.graphable
        and (generator is None or hasattr(torch.cuda.CUDAGraph, "register_generator_state"))
    )


class _Capture:
    """A CUDA graph of ``fn``'s device work, recorded on ``stream`` (nothing
    runs). ``outputs`` are fn's results: fixed tensors each
    :meth:`replay` rewrites. Python's garbage collector is held off while
    recording: a graph it destroyed meanwhile (another map's, dropped in a
    reference cycle) would end the recording. ``pool``: the memory pool it
    shares with the other graphs of its key. ``launches``: the counted
    kernels each replay runs (module docstring)."""

    def __init__(self, fn, stream, pool, generator: Optional[torch.Generator] = None) -> None:
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = dict(permuto_cuda.LAUNCHES)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    self.outputs = fn()
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated; the first error is the one to see
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n - before[k] for k, n in permuto_cuda.LAUNCHES.items() if n != before[k]}
        for k, n in self.launches.items():
            permuto_cuda.LAUNCHES[k] -= n

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            permuto_cuda.LAUNCHES[k] += n


class _Pre(NamedTuple):
    """The pre graph's outputs."""

    target: sampling.Target
    sub_params: dict  # the target fields' parameters (F, ...)
    samples: render.RaySamples
    coords: torch.Tensor  # (F, 3, R*S) field-local sample coordinates
    stats: tuple  # single view: (target slots filled, eligible fields), 0-d


class _Segments(NamedTuple):
    """One key's recorded iteration, and every tensor its graphs read that
    nothing else holds (a replay uses their memory, which must not return
    to the allocator while the graphs live)."""

    pre: _Capture
    enc: torch.Tensor  # the encode's output, copied in before the post graph
    post: _Capture  # -> (loss terms, d loss / d enc, {MLP key: gradient or None})
    grads: dict  # the Adam graph's gradients: the table's copied in, the MLP's from post
    adam: _Capture


class FrameGraphs:
    """The graphs of one map's frame step (module docstring). The map calls
    :meth:`frame` for each frame that trains fields."""

    def __init__(self, fset, rcfg, ocfg, loss_cfg, num_train_fields: int, single_view: bool,
                 generator: Optional[torch.Generator], device) -> None:
        self._fset, self._rcfg, self._ocfg, self._loss_cfg = fset, rcfg, ocfg, loss_cfg
        self._num_train_fields = num_train_fields
        self._single_view = single_view
        self._gen = generator  # None: every draw comes from a DrawSource
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._enc = fset.prototype.encoding
        self._key = None
        self._reset(None)

    def _reset(self, key) -> None:
        """Drop the graphs and the buffers of the last key. The new key's
        graphs share one memory pool: they replay one after another on one
        stream, and each keeps its outputs, so one graph's scratch memory can
        be another's."""
        self._key = key
        self._segments: Optional[_Segments] = None
        self._observed: Optional[_Capture] = None
        self._pool = torch.cuda.graph_pool_handle() if self._device.type == "cuda" else None
        self._iter_warm = self._observed_warm = False
        self._fixed: dict = {}  # the frame's inputs, copied in before each replay
        self._draws: dict = {}  # the iteration's draws, copied in before each replay

    @staticmethod
    def _key_of(camera, params, adam, arrays, cache) -> tuple:
        tensors = [*params.values(), *adam.m.values(), *adam.v.values(), adam.steps, arrays.positions,
                   arrays.orientations, arrays.training_iterations, *cache]
        return (id(camera),) + tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)

    @staticmethod
    def _copy_in(store: dict, name: str, value: torch.Tensor) -> torch.Tensor:
        """``value`` copied into the buffer ``store[name]``, made at the
        first copy -> the buffer."""
        buf = store.get(name)
        if buf is None:
            buf = store[name] = torch.empty_like(value, memory_format=torch.contiguous_format)
        return buf.copy_(value)

    def _fixed_copy(self, name: str, value: torch.Tensor) -> torch.Tensor:
        return self._copy_in(self._fixed, name, value)

    def _fixed_draws(self, draws: engine.IterationDraws) -> engine.IterationDraws:
        """A DrawSource's draws copied into this key's buffers -> the buffers
        (None where the source gives none)."""
        return engine.IterationDraws(**{name: self._copy_in(self._draws, name, value)
                                        for name, value in draws._asdict().items() if value is not None})

    def _record(self, fn, warm: bool = True, draws: bool = False) -> _Capture:
        """``fn`` recorded into a graph on the capture stream, the map's
        generator registered where ``fn`` ``draws``; with ``warm`` run once
        there first, the generator's state kept (a warm-up draws nothing that
        the step would). Only an ``fn`` that writes nothing outside its own
        outputs, and launches no counted kernel, may be warmed: a warm-up is
        no step."""
        stream = self._stream
        gen = self._gen if draws else None
        stream.wait_stream(torch.cuda.current_stream())
        if warm:
            state = None if gen is None else gen.get_state()
            with torch.cuda.stream(stream):
                fn()
            if state is not None:
                gen.set_state(state)
        captured = _Capture(fn, stream, self._pool, generator=gen)
        torch.cuda.current_stream().wait_stream(stream)
        return captured

    # -- one frame ------------------------------------------------------------

    def frame(self, *, camera, params: dict, adam: optimizer.AdamState, arrays, cache: tuple,
              allocated: torch.Tensor, num_iters: int, rgbd=None, c2w=None, observed_gumbel=None,
              active=None, iteration_draws=None):
        """One frame's observed-field test (multi-view) and ``num_iters``
        iterations; ``cache`` is (rgb, depth, c2w, valid), ``active`` the
        single view's active-field mask. Updates the map in place -> (the
        observed mask or None, the last iteration's loss dict)."""
        key = self._key_of(camera, params, adam, arrays, cache)
        if key != self._key:
            self._reset(key)
        self._fixed_copy("allocated", allocated)
        observed = None
        if self._single_view:
            self._fixed_copy("mask", active)
        else:
            with profiling.span("ngm.frame.observed"):
                observed = self._observed_test(camera, arrays.positions, rgbd, c2w, observed_gumbel)
        loss_dict = {}
        for i in range(num_iters):
            draws = iteration_draws[i] if iteration_draws else engine.IterationDraws()
            loss_dict = self._iteration(i, draws, camera, params, adam, arrays, cache)
        return observed, loss_dict

    def _observed_test(self, camera, positions, rgbd, c2w, gumbel) -> torch.Tensor:
        """The frame's observed-field test into the buffer ``mask``, which
        the pre graph reads -> that buffer."""
        fixed = self._fixed
        if self._observed is None and not self._observed_warm:
            observed = sampling.observed_fields_mask(
                camera, rgbd[..., 3], c2w, positions, fixed["allocated"], self._fset.field_radius,
                gumbel=gumbel, generator=self._gen,
            )
            self._observed_warm = True
            return self._fixed_copy("mask", observed)
        depth = self._fixed_copy("depth", rgbd[..., 3])
        pose = self._fixed_copy("c2w", c2w)
        noise = None if gumbel is None else self._fixed_copy("gumbel", gumbel)
        mask = fixed["mask"]  # the warm frame's test made it
        if self._observed is None:
            def test():
                mask.copy_(sampling.observed_fields_mask(
                    camera, depth, pose, positions, fixed["allocated"], self._fset.field_radius,
                    gumbel=noise, generator=self._gen,
                ))

            self._observed = self._record(test, draws=True)
        self._observed.replay()
        return mask

    # -- one iteration ----------------------------------------------------------

    def _iteration(self, i: int, draws, camera, params, adam, arrays, cache) -> dict:
        profiling.count("step.iterations")
        if self._segments is None and not self._iter_warm:
            self._iter_warm = True
            return self._eager_iteration(i, draws, camera, params, adam, arrays, cache)
        with profiling.span("ngm.iter.sample"):
            fixed_draws = self._fixed_draws(draws)
            if self._single_view:
                odd = self._fixed.get("odd")
                if odd is None:
                    odd = self._fixed["odd"] = torch.zeros((), dtype=torch.bool, device=self._device)
                odd.fill_(i % 2 != 0)
            if self._segments is None:
                # not warmed: the key's eager iteration ran its kernels, batched_gather among them
                pre = self._record(lambda: self._pre(camera, params, arrays, cache, fixed_draws), warm=False,
                                   draws=True)
            else:
                pre = self._segments.pre
            pre.replay()
        out: _Pre = pre.outputs
        if self._single_view and profiling.tracing_on():  # the sampler's counters, from the graph's outputs
            profiling.count("sv.slots_valid", out.stats[0].clone())
            profiling.count("sv.slots", self._num_train_fields)
            profiling.count("sv.fields_eligible", out.stats[1].clone())
        with profiling.span("ngm.iter.render"):
            enc = self._enc.fused_forward(out.sub_params["enc.table"], out.coords)
            if self._segments is None:
                enc_in = enc.clone()
                post = self._record(lambda: self._post(out, enc_in))
            else:
                enc_in, post = self._segments.enc, self._segments.post
                enc_in.copy_(enc)
            post.replay()
            values, grad_enc, mlp_grads = post.outputs
        with profiling.span("ngm.iter.backward"):
            table_grad = self._enc.fused_table_grad(out.coords, grad_enc)
        with profiling.span("ngm.iter.adam"):
            if self._segments is None:
                grads = {"enc.table": table_grad.clone(), **mlp_grads}
                step = self._record(lambda: self._adam(params, adam, arrays, out, grads), warm=False)
                self._segments = _Segments(pre, enc_in, post, grads, step)
            else:
                self._segments.grads["enc.table"].copy_(table_grad)
            self._segments.adam.replay()
        profiling.count("step.graphed")
        return dict(zip(self._loss_keys, values.unbind(0)))

    def _eager_iteration(self, i, draws, camera, params, adam, arrays, cache) -> dict:
        """The iteration through the engine's eager code (a new key's first)."""
        fixed = self._fixed
        common = (self._fset, camera, self._rcfg, self._ocfg, self._loss_cfg, self._num_train_fields)
        if self._single_view:
            _, _, _, loss_dict = engine.optimization_iteration_sv(
                *common, i, params, adam, arrays.training_iterations, arrays.positions, arrays.orientations,
                fixed["mask"], *cache, draws=draws, generator=self._gen,
            )
        else:
            _, _, _, loss_dict = engine.optimization_iteration(
                *common, params, adam, arrays.training_iterations, arrays.positions, arrays.orientations,
                fixed["allocated"], fixed["mask"], *cache, draws=draws, generator=self._gen,
            )
        return loss_dict

    # -- the segments (what the graphs record) ------------------------------------

    def _pre(self, camera, params, arrays, cache, draws) -> _Pre:
        fset, fixed, gen = self._fset, self._fixed, self._gen
        cache_rgb, cache_depth, cache_c2w, cache_valid = cache
        stats = ()
        if self._single_view:
            slot = engine.sv_slot(cache_valid, fixed["odd"], draws.slot_gumbel, gen)
            view, view_c2w = engine.sv_view(cache_rgb, cache_depth, cache_c2w, slot)
            target, eligible = sampling.sample_target_sv_eligible(
                camera, view, view_c2w, arrays.positions, fixed["mask"], fset.field_radius,
                self._num_train_fields, self._loss_cfg.num_rays_per_field,
                cloud_idx=draws.cloud_idx, u_fields=draws.u_fields, u_rays=draws.u_rays, generator=gen,
            )
            stats = (target.field_valid.sum(), eligible.sum())
        else:
            target = engine.mv_target(
                fset, camera, self._loss_cfg, self._num_train_fields, arrays.positions, fixed["allocated"],
                fixed["mask"], *cache, draws, gen,
            )
        ids = target.field_ids
        sub_params = fset.gather_fields(params, ids)
        samples = render.sample_rays(camera, target, self._rcfg, draws.u_coarse, draws.u_guided, gen)
        local = fset.world_to_local_soa(samples.points, arrays.positions[ids], arrays.orientations[ids])
        return _Pre(target, sub_params, samples, torch.stack(local, dim=-2).contiguous(), stats)

    def _post(self, pre: _Pre, enc: torch.Tensor) -> tuple:
        """MLP, compositing and losses from the encoded features, and their
        backward -> (every loss term stacked, in the eager loss dict's order;
        d loss / d enc; {MLP key: its gradient, zeros where the loss does not
        reach it})."""
        enc = enc.detach().requires_grad_(True)
        mlp = {k: v.detach().requires_grad_(True) for k, v in pre.sub_params.items() if k != "enc.table"}
        outs = self._fset.prototype.mlp_fm(mlp, enc)
        pred = render.composite(mlp, pre.target, pre.samples, outs, self._rcfg)
        combined, loss_dict = engine.compute_losses(self._loss_cfg, self._rcfg, pre.target, pred)
        self._loss_keys = list(loss_dict)
        grads = engine._grads(combined, {**mlp, "enc.table": enc})  # that key: d loss / d enc
        return torch.stack([v.detach() for v in loss_dict.values()]), grads.pop("enc.table"), grads

    def _adam(self, params, adam, arrays, pre: _Pre, grads: dict) -> None:
        target, ti = pre.target, arrays.training_iterations
        optimizer.adam_slice_update(self._ocfg, params, adam, target.field_ids, target.field_valid, grads,
                                    pre.sub_params)
        ti.index_add_(0, target.field_ids, target.field_valid.to(ti.dtype))
