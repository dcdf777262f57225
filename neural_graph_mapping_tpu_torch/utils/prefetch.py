"""Host-side frame prefetch: decode (and upload) ahead of the training loop
(port of neural_graph_mapping_tpu.utils.prefetch).

A single daemon thread reads the upcoming frames into a bounded queue while
the device executes the current frame's optimization: during device work
the training loop waits in a call that releases the GIL, so the decode is
hidden behind compute instead of serialized in front of it. Frames are
consumed strictly in order; one thread suffices.

With ``to_device`` the worker also starts each frame's host-to-device copy:
the RGB-D array goes into pinned host memory, is copied with
``non_blocking=True`` on a side stream, and an event is recorded after the
copy. :meth:`FramePrefetcher.get` makes the consumer's current stream wait
on that event before handing the tensor over, and records the tensor's use
on that stream for the caching allocator. The frame is shipped as it was
read (float32 RGB-D), so the device copy equals the synchronous upload byte
for byte; the JAX package ships RGB as 8 bits to spare its slower link.

While the tracer is on (``utils/profiling.py``), the worker's read and
upload and the consumer's wait are spans ``ngm.input.*``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Sequence

import numpy as np
import torch

from neural_graph_mapping_tpu_torch.utils import profiling


class FramePrefetcher:
    """Iterates ``dataset[fid] for fid in frame_ids`` on a worker thread.

    ``get(fid)`` returns the item for the next expected frame id and
    re-raises any worker exception at the call site. Out-of-order or unknown
    ids fall back to a synchronous ``dataset[fid]`` (correct, just not
    overlapped), so callers never deadlock on a mismatched schedule. With
    ``to_device`` the items it serves carry ``"rgbd_dev"``, the (H, W, 4)
    float32 frame on ``device``, ready to use on the current stream.
    """

    _SENTINEL = object()

    def __init__(
        self,
        dataset,
        frame_ids: Iterable[int],
        depth: int = 2,
        to_device: bool = False,
        device="cuda",
    ):
        self._dataset = dataset
        self._ids: Sequence[int] = list(frame_ids)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._pos = 0
        self._stop = threading.Event()
        self._to_device = bool(to_device)
        self._device = torch.device(device)
        self._stream = None
        if self._to_device and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
        self._thread = threading.Thread(target=self._work, name="ngm-frame-prefetch", daemon=True)
        self._thread.start()

    def _upload(self, rgbd):
        """Start the copy of one frame -> (device tensor, event or None)."""
        host = torch.from_numpy(np.ascontiguousarray(rgbd, dtype=np.float32))
        if self._stream is None:
            return host.to(self._device), None
        pinned = host.pin_memory()
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            dev = pinned.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _work(self) -> None:
        try:
            for fid in self._ids:
                # checked before each read so close() on an early abort stops
                # the worker after at most one in-flight item
                if self._stop.is_set():
                    break
                with profiling.span("ngm.input.read", frame=fid):
                    item = self._dataset[fid]
                if self._to_device:
                    item = dict(item)
                    with profiling.span("ngm.input.upload", frame=fid):
                        item["rgbd_dev"] = self._upload(item["rgbd"])
                self._queue.put((fid, item, None))
        except BaseException as exc:  # noqa: BLE001 — re-raised in get()
            self._queue.put((None, None, exc))
        finally:
            self._queue.put(self._SENTINEL)

    def get(self, frame_id: int):
        if self._pos < len(self._ids) and self._ids[self._pos] == frame_id:
            self._pos += 1
            with profiling.span("ngm.input.wait", frame=frame_id):
                entry = self._queue.get()
            if entry is self._SENTINEL:
                raise RuntimeError("prefetch worker ended before the sequence")
            fid, item, exc = entry
            if exc is not None:
                raise exc
            assert fid == frame_id
            if self._to_device:
                dev, event = item["rgbd_dev"]
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    dev.record_stream(current)
                item["rgbd_dev"] = dev
            return item
        # schedule mismatch: serve synchronously rather than desync the queue
        with profiling.span("ngm.input.read", frame=frame_id):
            return self._dataset[frame_id]

    def close(self) -> None:
        """Drain so the daemon thread exits promptly (tests, early abort)."""
        self._stop.set()
        while self._thread.is_alive() or not self._queue.empty():
            try:
                if self._queue.get(timeout=0.5) is self._SENTINEL:
                    break
            except queue.Empty:
                continue
        self._thread.join(timeout=5.0)
