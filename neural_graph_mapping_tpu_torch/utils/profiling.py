"""Tracing / profiling utilities (port of
neural_graph_mapping_tpu.utils.profiling).

The ``benchmark`` decorator prints a call's wall time, nested calls
indented, behind a global switch; where the JAX package blocks until its
result is ready, this one calls ``torch.cuda.synchronize()``, and only when
the result holds CUDA tensors. ``device_trace`` wraps ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable

import torch


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, on the card, CUDA
    activity) around a code block; writes a Chrome trace into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ) as prof:
        yield prof


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
