"""The program's own spans and counters in a traced window: what the
port's tracer (``neural_graph_mapping_tpu_torch/utils/profiling.py``)
records, read from the exported Chrome trace and the tracer's counters.

The tracer's spans on the thread that runs the profiler are
``record_function`` ranges named ``ngm.<layer>.<stage>`` in the trace. The
spans of other threads (the prefetch worker's) the tracer keeps itself, in
Unix nanoseconds: :func:`reading` puts them into the trace as
``user_annotation`` events on their own thread ids, on the trace's clock
(``baseTimeNanoseconds``), writes the trace back once, and reduces it:

- ``spans``: {name: {"s": seconds inside the window, "n": count}};
- ``graph_device_s``: {name: device seconds of the work replayed by the
  CUDA graph launches that the main thread made while ``name`` was its
  innermost open program span (the trace gives each replayed kernel, copy
  and fill the correlation id of its launch)};
- ``counters``: the tracer's counters, read once after the window;
- ``idle_by_span``: the window's device-idle seconds credited to the
  innermost program span open on the main thread (``main``), and to each
  ``ngm.input.*`` span open on another thread (``other``), with the ten
  longest idle gaps and their innermost main-thread span (``gaps``);
- ``coverage``: the share of the window's kernel launches made inside a
  program span (one of their own thread's, or while one is open on the
  main thread: autograd launches the backward's kernels from its own
  thread while the main thread waits in ``autograd.grad``), of
  ``process_frame``'s time its named children cover and of
  ``render_image``'s time its blocks cover.

A program without the tracer gives ``None``, and every metric read from it
is left out of the result line.
"""

from __future__ import annotations

import bisect
import json
import os
import pathlib
from typing import Dict, List, Optional

from port_bench import manifest as mf
from port_bench import tracing

PREFIX = "ngm."
INPUT_PREFIX = "ngm.input."
MERGED_KEY = "ngmRecordedSpans"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FRAME_CHILDREN = ("ngm.frame.graph", "ngm.frame.alloc", "ngm.frame.host_misc", "ngm.frame.step")
NO_SPAN = "(no program span)"

_memo: Dict[tuple, dict] = {}


def trace_path(workload: str) -> pathlib.Path:
    """Where the harness exports a cell's traced window."""
    return mf.HERE / ".cache" / f"trace-{workload}.json"


def program_tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from neural_graph_mapping_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, k) for k in ("recorded_spans", "counters", "SPANS")):
        return None
    return profiling


def merge_recorded(trace: dict, recorded: List[tuple]) -> int:
    """Add the tracer's own spans to ``trace`` as ``user_annotation`` events
    of the window's process, once -> the number added."""
    if trace.get(MERGED_KEY) is not None:
        return 0
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    window = _window_event(trace["traceEvents"])
    pid = window["pid"] if window else 0
    added = [{"ph": "X", "cat": "user_annotation", "name": name, "pid": pid, "tid": tid,
              "ts": t0 / 1e3 - base_us, "dur": (t1 - t0) / 1e3, "args": dict(ids)}
             for name, tid, t0, t1, ids in recorded]
    trace["traceEvents"].extend(added)
    trace[MERGED_KEY] = len(added)
    return len(added)


def _window_event(events) -> Optional[dict]:
    for e in events:
        if e.get("name") == tracing.WINDOW_SPAN and e.get("cat") == "user_annotation":
            return e
    return None


def _clip(s: float, e: float, w0: float, w1: float) -> float:
    return max(0.0, min(e, w1) - max(s, w0))


def _overlap(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint [s, e] intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost_segments(spans: list) -> list:
    """Nested spans of one thread, [(start, end, name)] -> disjoint pieces
    [(start, end, name of the innermost span open there)] covering their
    union, in time order."""
    points = sorted({t for s, e, _ in spans for t in (s, e)})
    starts = sorted(spans, key=lambda x: (x[0], -x[1]))
    stack: list = []
    out: list = []
    k = 0
    for p, q in zip(points, points[1:]):
        stack = [x for x in stack if x[1] > p]
        while k < len(starts) and starts[k][0] <= p:
            if starts[k][1] > p:
                stack.append(starts[k])
            k += 1
        if stack:
            out.append((p, q, stack[-1][2]))
    return out


def _credit(idle: list, pieces: list, into: Dict[str, float]) -> None:
    """Add each idle interval's overlap with each named piece to ``into``
    (seconds), and what no piece covers to NO_SPAN."""
    ends = [p[1] for p in pieces]
    for s, e in idle:
        covered = 0.0
        k = bisect.bisect_right(ends, s)
        while k < len(pieces) and pieces[k][0] < e:
            ov = max(0.0, min(e, pieces[k][1]) - max(s, pieces[k][0]))
            if ov > 0:
                into[pieces[k][2]] = into.get(pieces[k][2], 0.0) + ov / 1e6
                covered += ov
            k += 1
        if e - s - covered > 0:
            into[NO_SPAN] = into.get(NO_SPAN, 0.0) + (e - s - covered) / 1e6


def _innermost_at(pieces: list, s: float, e: float) -> str:
    """The innermost span that covers most of [s, e], by name."""
    by_name: Dict[str, float] = {}
    _credit([(s, e)], pieces, by_name)
    return max(by_name.items(), key=lambda kv: kv[1])[0]


def _graph_device_s(events: list, dev: list, pieces: list, main, w0: float, w1: float) -> Dict[str, float]:
    """Device seconds of the window's device events ``dev`` that a CUDA graph
    launch on the thread ``main`` replayed, by the innermost span of
    ``pieces`` open at the launch (NO_SPAN outside them)."""
    ends = [p[1] for p in pieces]

    def innermost(t: float) -> str:
        k = bisect.bisect_right(ends, t)
        return pieces[k][2] if k < len(pieces) and pieces[k][0] <= t else NO_SPAN

    launched = {e["args"]["correlation"]: innermost(float(e["ts"])) for e in events
                if e.get("cat") in LAUNCH_CATS and "GraphLaunch" in str(e.get("name", "")) and e.get("tid") == main
                and "correlation" in e.get("args", {}) and w0 <= float(e["ts"]) < w1}
    out: Dict[str, float] = {}
    for e in dev:
        name = launched.get(e.get("args", {}).get("correlation"))
        if name is not None:
            out[name] = out.get(name, 0.0) + float(e["dur"]) / 1e6
    return out


def reduce_spans(events: list) -> dict:
    """The program's spans in the harness's window of ``events`` ->
    ``spans``, ``idle_by_span`` and ``coverage`` (see the module)."""
    window = _window_event(events)
    if window is None:
        raise RuntimeError(f"the trace holds no {tracing.WINDOW_SPAN} span")
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    main = window["tid"]
    prog = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)
            and _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), w0, w1) > 0]

    spans: Dict[str, dict] = {}
    for e in prog:
        s = spans.setdefault(e["name"], {"s": 0.0, "n": 0})
        s["s"] += _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), w0, w1) / 1e6
        s["n"] += 1

    dev = [e for e in events if e.get("cat") in tracing.DEVICE_CATS and e.get("ph") == "X"
           and w0 <= float(e["ts"]) < w1]
    busy = tracing._union((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    main_spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in prog
                  if e.get("tid") == main]
    pieces = innermost_segments(main_spans)
    graph_device_s = _graph_device_s(events, dev, pieces, main, w0, w1)
    by_main: Dict[str, float] = {}
    _credit(idle, pieces, by_main)
    by_other: Dict[str, float] = {}
    for name in sorted({e["name"] for e in prog if e.get("tid") != main and e["name"].startswith(INPUT_PREFIX)}):
        ivs = tracing._union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in prog
                             if e.get("tid") != main and e["name"] == name)
        by_other[name] = _overlap([list(iv) for iv in idle], ivs) / 1e6
    gaps = sorted(idle, key=lambda iv: iv[0] - iv[1])[:10]

    by_tid: Dict[object, list] = {}
    for e in prog:
        by_tid.setdefault(e.get("tid"), []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    unions = {tid: tracing._union(ivs) for tid, ivs in by_tid.items()}
    starts = {tid: [iv[0] for iv in u] for tid, u in unions.items()}
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS and "LaunchKernel" in str(e.get("name", ""))
                and w0 <= float(e["ts"]) < w1]
    def within(tid, t: float) -> bool:
        k = bisect.bisect_right(starts.get(tid, []), t) - 1
        return k >= 0 and t <= unions[tid][k][1]

    inside = sum(1 for e in launches if within(e.get("tid"), float(e["ts"])) or within(main, float(e["ts"])))
    off_main = sum(1 for e in launches if e.get("tid") != main)

    def main_s(*names) -> float:
        return sum(_clip(s, t, w0, w1) for s, t, n in main_spans if n in names) / 1e6

    frame_s, image_s = main_s("ngm.frame.process"), main_s("ngm.render.image")
    return {
        "spans": spans,
        "graph_device_s": graph_device_s,
        "idle_by_span": {"idle_s": sum(e - s for s, e in idle) / 1e6, "main": by_main, "other": by_other,
                         "main_tid": main,
                         "gaps": [[_innermost_at(pieces, s, e), (e - s) / 1e6] for s, e in gaps]},
        "coverage": {"launches": len(launches), "launches_off_main": off_main,
                     "launches_in_span": inside / len(launches) if launches else None,
                     "frame_children": main_s(*FRAME_CHILDREN) / frame_s if frame_s else None,
                     "render_blocks": main_s("ngm.render.block") / image_s if image_s else None},
    }


def reading(r: dict) -> Optional[dict]:
    """The program's spans, counters and idle credit of the traced window of
    the reading ``r`` (once a trace), or None without the program's tracer
    or its spans. Raises where the harness left no trace at
    :func:`trace_path`: readers take only traced readings."""
    profiling = program_tracer()
    if profiling is None or not r.get("workload"):
        return None
    path = trace_path(r["workload"])
    if not path.is_file():
        raise FileNotFoundError(f"a traced reading of {r['workload']} without its exported trace at {path}")
    key = (str(path), r.get("window_s"))
    if key not in _memo:
        trace = json.loads(path.read_text())
        if merge_recorded(trace, profiling.recorded_spans()):
            tmp = path.with_suffix(".tmp")
            tmp.write_text(json.dumps(trace))
            os.replace(tmp, path)
        out = reduce_spans(trace["traceEvents"])
        if not out["spans"]:
            _memo[key] = None
        else:
            out["counters"] = profiling.counters()
            _memo[key] = out
            print(json.dumps({"phase": "spans", **out}), flush=True)
    return _memo[key]


def span_s(r: dict, name: str) -> Optional[float]:
    """Seconds of the span ``name`` in the window, None without them."""
    red = reading(r)
    if red is None or name not in red["spans"]:
        return None
    return red["spans"][name]["s"]
