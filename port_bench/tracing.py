"""The traced run: spans around the calls into the program, device time by
operation entry, and the reduction of the profiler's trace.

Device time is attributed to an operation by its entry in
``ops/permuto_cuda.py``, not by the names of the kernels behind it: each
wrapped entry is bracketed on its stream by two marker kernels
(``torch.cuda._sleep(0)``), and every device operation that runs between a
pair belongs to that call. A later change that fuses, splits or renames the
kernels behind an entry keeps the metric's meaning. The entry's operations
and bytes are counted from the same call's inputs (:mod:`port_bench.counts`).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
from typing import Callable, Dict, List, Optional

import torch

from port_bench import counts

MARKER = "spin_kernel"  # the device kernel of torch.cuda._sleep
WINDOW_SPAN = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span of the harness, named in the trace."""
    return torch.profiler.record_function(f"port_bench.{name}")


class EntryCounter:
    """Wraps the program's operation entries for a traced window and keeps,
    per call in order, the entry's name and the counts of its inputs."""

    def __init__(self, permuto_cuda, dispatch, mlp_widths) -> None:
        self._pc = permuto_cuda
        self._dispatch = dispatch
        self._mlp_fwd, self._mlp_bwd = counts.mlp_flops(mlp_widths)
        self.calls: List[tuple] = []  # (entry, {"bytes", "ops", "flops"})
        self._routed: Optional[tuple] = None
        self._saved: Dict[object, Dict[str, Callable]] = {}

    def _bracket(self, name: str, fn: Callable, count: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            torch.cuda._sleep(0)
            out = fn(*args, **kwargs)
            torch.cuda._sleep(0)
            self.calls.append((name, count(out, *args, **kwargs)))
            return out
        return wrapped

    def _fwd(self, out, table, coords, *rest, **kw):
        c = counts.encode_fwd(table, coords)
        return dict(c, flops=c["ops"] + c["points"] * self._mlp_fwd)

    def _bwd(self, out, coords, g, *rest, **kw):
        c = counts.encode_bwd_table(coords, g, out.shape[-2], out.shape[-1])
        return dict(c, flops=c["ops"] + c["points"] * self._mlp_bwd)

    def _moe_rays(self, out, tables, *rest, **kw):
        pairs, experts = self._routed
        c = counts.moe_rays(pairs, experts, tables.shape[2], tables.shape[3])
        return dict(c, flops=c["ops"] + pairs * self._mlp_fwd)

    def __enter__(self):
        pc, disp = self._pc, self._dispatch
        self._saved = {pc: {k: getattr(pc, k) for k in ("encode_fwd", "encode_bwd_table", "encode_fwd_moe_rays")},
                       disp: {"tiled_dispatch_sorted": disp.tiled_dispatch_sorted}}
        pc.encode_fwd = self._bracket("encode_fwd", self._saved[pc]["encode_fwd"], self._fwd)
        pc.encode_bwd_table = self._bracket("encode_bwd_table", self._saved[pc]["encode_bwd_table"], self._bwd)
        pc.encode_fwd_moe_rays = self._bracket("encode_fwd_moe_rays", self._saved[pc]["encode_fwd_moe_rays"],
                                               self._moe_rays)
        dispatch_sorted = self._saved[disp]["tiled_dispatch_sorted"]

        def routed(expert_ids, pair_valid, payloads, num_experts, tile):
            out = dispatch_sorted(expert_ids, pair_valid, payloads, num_experts, tile)
            self._routed = counts.routed_pairs(pair_valid, out[3], out[4], out[5], num_experts)
            return out

        disp.tiled_dispatch_sorted = routed
        return self

    def __exit__(self, *exc):
        for mod, attrs in self._saved.items():
            for k, v in attrs.items():
                setattr(mod, k, v)
        return False

    def totals(self) -> Dict[str, dict]:
        """{entry: {"calls", "bound_s", "flops"}} with the device counts read."""
        out: Dict[str, dict] = {}
        for name, c in self.calls:
            n_bytes, n_ops, flops = (float(c[k]) for k in ("bytes", "ops", "flops"))
            e = out.setdefault(name, {"calls": 0, "bound_s": [], "flops": 0.0})
            e["calls"] += 1
            e["bound_s"].append(counts.least_seconds(n_bytes, n_ops))
            e["flops"] += flops
        return out


@contextlib.contextmanager
def profiled():
    """torch.profiler over host and device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(path: pathlib.Path, calls: List[tuple]) -> dict:
    """Read an exported Chrome trace -> the traced window's device
    reading: busy and window seconds, kernel launches, device seconds per
    entry call (None where the markers do not pair with the calls), the top
    device operations and the longest idle gaps by what the host was doing."""
    events = json.loads(path.read_text())["traceEvents"]
    window = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and w0 <= float(e["ts"]) < w1]
    busy = _union((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    kernels = [e for e in dev if e["cat"] == "kernel" and MARKER not in e["name"]]

    # device seconds of each bracketed call, in the order of the calls
    per_call: Optional[list] = []
    markers = [e for e in dev if e["cat"] == "kernel" and MARKER in e["name"]]
    stream = markers[0].get("args", {}).get("stream") if markers else None
    on_stream = sorted((e for e in dev if e.get("args", {}).get("stream") == stream), key=lambda e: float(e["ts"]))
    inside, acc = False, 0.0
    for e in on_stream:
        if MARKER in e["name"]:
            if inside:
                per_call.append(acc / 1e6)
            inside, acc = not inside, 0.0
        elif inside:
            acc += float(e["dur"])
    if inside or len(per_call) != len(calls):
        per_call = None

    by_name: Dict[str, float] = {}
    for e in kernels + [e for e in dev if e["cat"] != "kernel"]:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)),
                  reverse=True)[:10]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW_SPAN and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]

    def doing(s: float, t: float) -> str:
        best = {"user_annotation": ("", 0.0), "cpu_op": ("", 0.0)}
        for e in host:
            ov = min(t, float(e["ts"]) + float(e["dur"])) - max(s, float(e["ts"]))
            if ov > best[e["cat"]][1]:
                best[e["cat"]] = (e["name"], ov)
        names = [n for n in (best["user_annotation"][0], best["cpu_op"][0]) if n]
        return " / ".join(names) or "no host span"

    idle_gaps = [[doing(s, t), length / 1e6] for length, s, t in gaps if length > 0]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "launches": len(kernels),
            "per_call_s": per_call, "device_ops": [[n, s] for n, s in device_ops], "idle_gaps": idle_gaps}
