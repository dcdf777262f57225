"""The frame step's stages replayed from CUDA graphs.

:mod:`engine` writes the frame step once: ``frame_step``, and the loop the
two scans share (``_iterations``). A map's ``_graphs`` selects how each of
its stages runs: None, eagerly; a :class:`FrameGraphs`, from CUDA graphs of
the engine's own stage functions. One unsharded iteration launches some 750
kernels, and the host's enqueue of them, not the device, set the pace of a
trained frame. So an iteration is cut where it calls the hand-written
encode kernels, which stay eager Python calls (their shape-based routing,
and what a caller that wraps them sees, stay as they are); the stretches
between them are graphs, recorded once and replayed with one launch each:

- ``pre``: the iteration's target stage as the engine's loop hands it over
  (``engine.mv_target`` or ``engine.sv_target`` over this object's
  buffers), ``engine.gather_targets`` and ``engine.ray_samples``: the
  targets, the target fields' parameters and poses, the ray samples and
  their field-local coordinates, stacked (F, 3, P);
- ``permuto_cuda.encode_fwd``, eager;
- ``post``: ``engine.loss_and_grads`` from the encoded features (its
  ``cut``): the MLP, compositing, the losses and their backward down to the
  features and the MLP weights, recorded with autograd in one graph;
- ``permuto_cuda.encode_bwd_table`` on that gradient, eager;
- ``adam``: ``engine.adam_step``.

The replayed iteration calls the two encode entries itself, where the eager
one reaches them through autograd (``permuto._EncodeFused``): the same
calls, without autograd's engine, which would hand the backward to its
device thread and back each iteration. A multi-view frame's observed-field
test (``engine.observed_fields``) is a graph of its own.

Graphs read and write fixed tensors. The map's tensors (parameters, Adam
state, poses, training counts, keyframe cache) are updated in place, and
the frame's other inputs (the allocated mask, the observed or active mask,
the single-view parity, the frame's depth and pose, a
:class:`engine.DrawSource`'s draws, the encode's output and the table's
gradient) are copied into buffers of this object before each replay. The
graphs belong to a key: the address and shape of every map tensor they
touch, which a capacity growth or a loaded map changes. A new key drops
them with their memory; its first iteration (and observed test) runs
eagerly, through the engine's eager iteration, which warms every kernel at
the new shapes, and the next one records the graphs, whose own first
replay is that iteration's step, so no Adam step is ever applied twice.

Generator draws are drawn inside the graphs: each graph that draws
registers the map's generator (``CUDAGraph.register_generator_state``), so
a replay draws from the generator where the eager step would have, and a
recording draws nothing. Captures run on a side stream of this object in
the thread-local capture mode, so that the frame prefetcher's thread may
allocate and copy while one is underway.

A recording launches nothing, and a replay calls no kernel wrapper and no
counter: each graph takes back what its recording added to
``permuto_cuda.LAUNCHES`` and adds it again at every replay, so the counts
stay those of the kernels run, and adds the tracer's counters its
recording kept (the single-view sampler's) at every replay while tracing.
"""

from __future__ import annotations

import gc
from typing import Callable, NamedTuple, Optional

import torch

from neural_graph_mapping_tpu_torch.mapping import engine, render, sampling
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
    shares with the other graphs of its key. ``launches`` and ``counts``:
    the counted kernels and the tracer's counters of each replay (module
    docstring)."""

    def __init__(self, fn, stream, pool, generator: Optional[torch.Generator] = None) -> None:
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = dict(permuto_cuda.LAUNCHES)
        self.counts: list = []
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream), profiling.collected_counts(self.counts):
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
        if profiling.tracing_on():  # device values cloned: the next replay rewrites them
            for name, value in self.counts:
                profiling.count(name, value.clone() if isinstance(value, torch.Tensor) else value)


class _Pre(NamedTuple):
    """The pre graph's outputs."""

    target: sampling.Target
    sub_params: dict  # the target fields' parameters (F, ...)
    samples: render.RaySamples
    coords: torch.Tensor  # (F, 3, R*S) field-local sample coordinates


class _Segments(NamedTuple):
    """One key's recorded iteration, and every tensor its graphs read that
    nothing else holds (a replay uses their memory, which must not return
    to the allocator while the graphs live)."""

    pre: _Capture
    enc: torch.Tensor  # the encode's output, copied in before the post graph
    post: _Capture  # -> (loss terms, d loss / d enc, {MLP key: gradient})
    grads: dict  # the Adam graph's gradients: the table's copied in, the MLP's from post
    adam: _Capture


class FrameGraphs:
    """The graphs of one map's frame step (module docstring). The engine's
    frame loop calls :meth:`observed` for a multi-view frame's test and
    :meth:`iteration` for each iteration; ``maps`` is then (params, adam,
    training counts, positions, orientations, (cache RGB, depth, c2w,
    valid)), the map tensors that make the key."""

    def __init__(self, fset, rcfg, ocfg, loss_cfg, generator: Optional[torch.Generator], device) -> None:
        self._fset, self._rcfg, self._ocfg, self._loss_cfg = fset, rcfg, ocfg, loss_cfg
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
        self._sources: dict = {}  # the tensor last copied into each of them
        self._draws: dict = {}  # the iteration's draws, copied in before each replay

    def _bind(self, camera, maps: tuple) -> None:
        """A new key where ``maps`` are not the tensors of the last one."""
        params, adam, ti, positions, orientations, cache = maps
        tensors = [*params.values(), *adam.m.values(), *adam.v.values(), adam.steps, ti, positions, orientations,
                   *cache]
        key = (id(camera),) + tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)
        if key != self._key:
            self._reset(key)

    @staticmethod
    def _copy_in(store: dict, name: str, value: torch.Tensor) -> torch.Tensor:
        """``value`` copied into the buffer ``store[name]``, made at the
        first copy -> the buffer."""
        buf = store.get(name)
        if buf is None:
            buf = store[name] = torch.empty_like(value, memory_format=torch.contiguous_format)
        return buf.copy_(value)

    def _fixed_copy(self, name: str, value) -> torch.Tensor:
        """A frame input into its buffer -> the buffer. A Python bool fills a
        0-d one. A tensor is copied unless it is the buffer or the tensor
        last copied there: the engine hands each of a frame's iterations the
        frame's masks, new tensors each frame that nothing changes in place."""
        buf = self._fixed.get(name)
        if isinstance(value, bool):
            if buf is None:
                buf = self._fixed[name] = torch.zeros((), dtype=torch.bool, device=self._device)
            return buf.fill_(value)
        if value is buf or value is self._sources.get(name):
            return buf
        self._sources[name] = value
        return self._copy_in(self._fixed, name, value)

    def _record(self, fn, warm: bool = True, draws: bool = False) -> _Capture:
        """``fn`` recorded into a graph on the capture stream, the map's
        generator registered where ``fn`` ``draws``; with ``warm`` run once
        there first, the generator's state kept (a warm-up draws nothing that
        the step would) and its counters dropped. Only an ``fn`` that writes
        nothing outside its own outputs, and launches no counted kernel, may
        be warmed: a warm-up is no step."""
        stream = self._stream
        gen = self._gen if draws else None
        stream.wait_stream(torch.cuda.current_stream())
        if warm:
            state = None if gen is None else gen.get_state()
            with torch.cuda.stream(stream), profiling.collected_counts([]):
                fn()
            if state is not None:
                gen.set_state(state)
        captured = _Capture(fn, stream, self._pool, generator=gen)
        torch.cuda.current_stream().wait_stream(stream)
        return captured

    def observed(self, camera, maps: tuple, depth, c2w, allocated, gumbel) -> torch.Tensor:
        """The frame's observed-field test (``engine.observed_fields``) into
        the buffer ``mask``, an iteration's input of that name: a new key's
        first test eagerly, its second recorded, later ones replayed -> that
        buffer."""
        self._bind(camera, maps)
        fset, positions, gen = self._fset, maps[3], self._gen
        if self._observed is None and not self._observed_warm:
            self._observed_warm = True
            return self._fixed_copy("mask", engine.observed_fields(fset, camera, depth, c2w, positions, allocated,
                                                                   gumbel, gen))
        depth, c2w = self._fixed_copy("depth", depth), self._fixed_copy("c2w", c2w)
        allocated = self._fixed_copy("allocated", allocated)
        gumbel = None if gumbel is None else self._copy_in(self._draws, "gumbel", gumbel)  # a draw: always
        mask = self._fixed["mask"]  # the warm frame's test made it
        if self._observed is None:
            self._observed = self._record(lambda: mask.copy_(engine.observed_fields(
                fset, camera, depth, c2w, positions, allocated, gumbel, gen)), draws=True)
        self._observed.replay()
        return mask

    def iteration(self, camera, maps: tuple, targets: Callable, inputs: dict, draws: engine.IterationDraws,
                  eager: Callable[[], dict]) -> dict:
        """One iteration: a new key's first through ``eager()``, the engine's
        eager iteration; its second recorded; later ones replayed.
        ``targets(buffers, draws, generator)``: the iteration's target stage
        over this object's buffers of ``inputs`` -> the loss dict."""
        self._bind(camera, maps)
        if self._segments is None and not self._iter_warm:
            self._iter_warm = True
            return eager()
        params, adam, ti, positions, orientations, _ = maps
        seg = self._segments
        with profiling.span("ngm.iter.sample"):
            fixed = {name: self._fixed_copy(name, value) for name, value in inputs.items()}
            fixed_draws = engine.IterationDraws(**{name: self._copy_in(self._draws, name, value)
                                                   for name, value in draws._asdict().items() if value is not None})
            if seg is None:
                # not warmed: the key's eager iteration ran its kernels, batched_gather among them
                pre = self._record(lambda: self._pre(camera, targets, fixed, fixed_draws, params, positions,
                                                     orientations), warm=False, draws=True)
            else:
                pre = seg.pre
            pre.replay()
        out: _Pre = pre.outputs
        with profiling.span("ngm.iter.render"):
            enc = self._enc.fused_forward(out.sub_params["enc.table"], out.coords)
            if seg is None:
                enc_in = enc.clone()
                post = self._record(lambda: self._post(camera, out, enc_in))
            else:
                enc_in, post = seg.enc, seg.post
                enc_in.copy_(enc)
            post.replay()
            values, grad_enc, mlp_grads = post.outputs
        with profiling.span("ngm.iter.backward"):
            table_grad = self._enc.fused_table_grad(out.coords, grad_enc)
        with profiling.span("ngm.iter.adam"):
            if seg is None:
                grads = {"enc.table": table_grad.clone(), **mlp_grads}
                step = self._record(lambda: engine.adam_step(self._ocfg, params, adam, ti, out.target, grads,
                                                             out.sub_params), warm=False)
                seg = self._segments = _Segments(pre, enc_in, post, grads, step)
            else:
                seg.grads["enc.table"].copy_(table_grad)
            seg.adam.replay()
        profiling.count("step.graphed")
        return dict(zip(self._loss_keys, values.unbind(0)))

    # -- what the graphs record ------------------------------------------------

    def _pre(self, camera, targets, fixed: dict, draws, params, positions, orientations) -> _Pre:
        fset, gen = self._fset, self._gen
        target = targets(fixed, draws, gen)
        sub_params, sub_positions, sub_orientations = engine.gather_targets(fset, params, positions, orientations,
                                                                            target)
        samples, coords = engine.ray_samples(fset, camera, self._rcfg, target, sub_positions, sub_orientations,
                                             draws, gen)
        return _Pre(target, sub_params, samples, torch.stack(coords, dim=-2).contiguous())

    def _post(self, camera, pre: _Pre, enc: torch.Tensor) -> tuple:
        """The loss stage from the encoded features -> (every loss term
        stacked, in the eager loss dict's order; d loss / d enc; {MLP key:
        its gradient, zeros where the loss does not reach it})."""
        loss_dict, grads = engine.loss_and_grads(self._fset, camera, self._rcfg, self._loss_cfg, pre.sub_params,
                                                 None, None, pre.target, cut=(pre.samples, enc))
        self._loss_keys = list(loss_dict)
        return torch.stack(list(loss_dict.values())), grads.pop("enc.table"), grads
