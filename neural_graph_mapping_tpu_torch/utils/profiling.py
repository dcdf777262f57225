"""Tracing and profiling (port of neural_graph_mapping_tpu.utils.profiling,
with the port's tracer).

The tracer marks the program's layer boundaries. ``span(name, **ids)``
opens a named range, ``count(name, value)`` adds to a named counter, and
``phase(name, into)`` times a host phase of the online loop into a dict
(the engine's ``phase_times``) and is a span besides. Spans and counters
are on exactly while a ``torch.profiler`` session records in this process
(:func:`tracing_on`), so that a profiled window gets its spans and counters
and an unprofiled run pays one flag check a call site.

Off, ``span`` returns one shared no-op context and ``count`` returns at
once: no ``record_function``, no tensor, no kernel launch. On, a span on a
thread that the profiler records is a ``torch.profiler.record_function``
range named ``ngm.<layer>.<stage>``: it lands in the profiler's Chrome
trace beside the device's kernels, on the same clock, and its ``ids``
(frame id, image and block index) ride in the range's ``args``, which a
profiler keeps when it records shapes. A span on any other thread (the
prefetch worker: the profiler records only the thread that started it) is
kept by the tracer itself as (name, native thread id, start and end in
Unix nanoseconds, ids), the clock of the trace's ``baseTimeNanoseconds``,
and read with :func:`recorded_spans`. Every span name the package uses is
in ``SPANS``, every counter in ``COUNTERS``.

Counters take host numbers, or 0-d device tensors where the value lives on
the device: those accumulate on the device without a host sync and are read
once, by :func:`counters`, after the window. While a CUDA graph records
(:func:`collected_counts`), the recording thread's counters are kept, traced
or not, and the graph adds them again at each replay.

The ``benchmark`` decorator prints a call's wall time, nested calls
indented, behind its own switch (the ``benchmark`` config key); where the
JAX package blocks until its result is ready, this one calls
``torch.cuda.synchronize()``, and only when the result holds CUDA tensors.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

SPANS: Dict[str, str] = {
    # frame input (utils/prefetch.py, utils/imageio.py)
    "ngm.input.read": "one dataset[frame_id]: the frame's files read and decoded",
    "ngm.input.decode": "one imageio.read_png: file read, inflate, row unfilter",
    "ngm.input.upload": "the prefetch worker's pinned copy and non-blocking upload on its side stream",
    "ngm.input.wait": "the consumer's wait in FramePrefetcher.get for the next queued frame",
    # online loop (mapping/engine.py NeuralGraphMap.process_frame; the CLI runner)
    "ngm.frame.process": "one NeuralGraphMap.process_frame",
    "ngm.frame.graph": "host phase: pose-graph update and re-anchoring",
    "ngm.frame.alloc": "host phase: keyframe slot and new-field allocation",
    "ngm.frame.host_misc": "host phase: slot poses and masks to the device",
    "ngm.frame.data_wait": "CLI phase: the wait for the next frame",
    "ngm.frame.h2d": "CLI phase: the frame to the device",
    "ngm.frame.step": "the frame's device program: draws, cache writes, observed test, iterations, losses' copy",
    "ngm.frame.draws": "a DrawSource's draws for the frame (tests, the benchmark)",
    "ngm.frame.cache_write": "the frame into the keyframe cache",
    "ngm.frame.observed": "the observed-field test",
    "ngm.frame.sync": "the losses' copy to the host, which waits for the device",
    # one optimization iteration (engine.optimization_iteration / _sv)
    "ngm.iter.select": "target field selection",
    "ngm.iter.sample": "target rays sampled from the keyframe cache",
    "ngm.iter.sv_cloud": "single view: the view gathered from the cache, its depth cloud and the centres in its frame",
    "ngm.iter.sv_count": "single view: each field's cloud segments through its sphere, streamed; eligibility",
    "ngm.iter.sv_rays": "single view: the chosen fields' dense hit mask, inverse-CDF ray draws and the targets",
    "ngm.iter.gather": "the target fields' parameters gathered",
    "ngm.iter.render": "forward render of the target rays",
    "ngm.iter.loss": "the loss terms",
    "ngm.iter.backward": "autograd.grad of the combined loss",
    "ngm.iter.adam": "per-field Adam step and training counts",
    # render (engine.render_image, render_block_tiled, fields.apply_knn_tiled)
    "ngm.render.image": "one render_image",
    "ngm.render.block": "one block of batched_evaluation",
    "ngm.render.span": "ray-sphere spans and sample distances",
    "ngm.render.route": "top-k routing of sample points to fields",
    "ngm.render.dispatch": "tile-sorted dispatch of the pairs and the tile buffers",
    "ngm.render.encode": "MoE encode of the tiles (with the field MLP where the kernel runs it)",
    "ngm.render.mlp": "per-tile MLP outside the encode (fields.NeuralField.mlp_fm)",
    "ngm.render.scatter_blend": "tile outputs back to pair order and the KNN blend",
    "ngm.render.composite": "quadrature of the samples into RGB-D",
}

COUNTERS: Dict[str, str] = {
    "render.pairs_valid": "(point, field) pairs inside a radius: tile_count over the live tiles (device)",
    "render.lanes_encoded": "lanes the MoE encode runs: live tiles x TILE (device)",
    "render.lanes_mlp": "lanes the per-tile MLP runs: live tiles x TILE in the encode (device), else all tiles x TILE (host)",
    "render.mlp_fused": "tiled dispatches whose MLP ran in the MoE encode (host)",
    "sv.slots_valid": "single-view target slots filled: the sum of field_valid (device)",
    "sv.slots": "single-view target slots run: F a sampler call (host)",
    "sv.fields_eligible": "fields with at least R cloud segments through their sphere (device)",
    "step.iterations": "training iterations run (host)",
    "step.graphed": "training iterations whose pre, post and Adam segments ran from CUDA graphs (host)",
}

MAX_RECORDED_SPANS = 1 << 20

_lock = threading.Lock()
_counters: Dict[str, object] = {}
_recorded: List[tuple] = []  # spans past MAX_RECORDED_SPANS are dropped
_collecting = threading.local()  # .into: the list a recording's counters go to


def tracing_on() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return _autograd_profiler._is_profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "ids", "_range", "_t0")

    def __init__(self, name: str, ids: dict) -> None:
        self.name, self.ids = name, ids

    def __enter__(self):
        if torch.autograd._profiler_enabled():  # the profiler records this thread
            args = ",".join(f"{k}={v}" for k, v in self.ids.items()) or None
            self._range = torch.profiler.record_function(self.name, args)
            self._range.__enter__()
        else:
            self._range = None
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        elif len(_recorded) < MAX_RECORDED_SPANS:
            # the thread's cached id: get_native_id() is a system call
            _recorded.append((self.name, threading.current_thread().native_id, self._t0, time.time_ns(), self.ids))
        return False


def span(name: str, **ids):
    """A context naming one stage of the program (``name`` in ``SPANS``)."""
    if not tracing_on():
        return _NO_SPAN
    return _Span(name, ids)


def counting() -> bool:
    """Whether :func:`count` keeps what it is given: while tracing, or while
    this thread records counters (:func:`collected_counts`)."""
    return tracing_on() or getattr(_collecting, "into", None) is not None


@contextlib.contextmanager
def collected_counts(into: list):
    """Within the block, this thread's :func:`count` calls append (name,
    value) to ``into``, traced or not, and add nothing: a CUDA graph's
    recording keeps its counters to add them at each replay."""
    _collecting.into = into
    try:
        yield into
    finally:
        _collecting.into = None


def count(name: str, value=1) -> None:
    """Add ``value`` (a host number or a 0-d device tensor, kept as it is
    given: pass one nothing writes later) to the counter ``name``."""
    into = getattr(_collecting, "into", None)
    if into is not None:
        into.append((name, value))
        return
    if not tracing_on():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if not value.is_floating_point():
            value = value.to(torch.int64)
    with _lock:
        prev = _counters.get(name)
        _counters[name] = value if prev is None else prev + value


def counters() -> Dict[str, float]:
    """Every counter's total, device counters read to the host here."""
    with _lock:
        items = list(_counters.items())
    return {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in items}


def recorded_spans() -> List[tuple]:
    """The spans the tracer kept itself: (name, native thread id, start ns,
    end ns, ids), Unix time."""
    return list(_recorded)


def reset() -> None:
    """Drop every counter and kept span."""
    with _lock:
        _counters.clear()
        _recorded.clear()


@contextlib.contextmanager
def phase(name: str, into: Dict[str, float]):
    """Add the block's host seconds to ``into[name]``, always; a span
    ``ngm.frame.<name>`` while tracing. The clock runs inside the span,
    so the seconds are the block's and not the tracer's."""
    with span(f"ngm.frame.{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0


def _holds_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    return False


def benchmark(f: Callable) -> Callable:
    """Print the wall time of each call (nested-indent aware).

    Toggle globally with ``benchmark.enabled = True/False``, which the
    ``benchmark`` config key sets. Drains the card before the call and
    waits for a result on the card, so the times are the work's.
    """

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        if not benchmark.enabled:
            return f(*args, **kwargs)
        benchmark.indent += 1
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()  # drain the queue
            t1 = time.time()
            result = f(*args, **kwargs)
            if _holds_cuda(result):
                torch.cuda.synchronize()
            t2 = time.time()
        finally:
            benchmark.indent -= 1
        print(f"{'  ' * benchmark.indent}{f.__name__} finished in {t2 - t1:.4f}")
        return result

    return wrapper


benchmark.enabled = False
benchmark.indent = 0


class ThroughputTracker:
    """Optimization-time accounting: accumulates per-frame optimization
    seconds, excluding logging, and derives fps/spf estimates."""

    def __init__(self) -> None:
        self.total_seconds = 0.0
        self.frames = 0
        self.frame_seconds: list = []  # each frame's, in order

    def add_frame(self, seconds: float) -> None:
        self.total_seconds += seconds
        self.frames += 1
        self.frame_seconds.append(seconds)

    @property
    def fps_estimate(self) -> float:
        return self.frames / self.total_seconds if self.total_seconds else 0.0

    @property
    def spf_estimate(self) -> float:
        return self.total_seconds / self.frames if self.frames else 0.0
