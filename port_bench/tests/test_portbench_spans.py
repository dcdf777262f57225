"""The per-layer metrics read from the program's own spans and counters
(``port_bench/spans.py``): their manifest entries, and a traced run of each
cell at a tiny size on the CPU, the profiler recording host activity only
(no device, so no entry markers), in which every one of them reads."""

import contextlib
import json
import time

import pytest

from port_bench import manifest as mf
from port_bench import run, spans
from port_bench.tests.tiny import tiny_cell

M = mf.load_manifest()
SOURCES = {"host_clock", "device_trace", "program_span", "program_counter"}
PROGRAM_METRICS = {
    "mv_replay": {"decode_ms.train": "program_span", "idle_under_decode_pct.train": "program_span",
                  "issue_ms.train": "program_span", "sync_wait_ms.train": "program_span"},
    "mv_render": {"mlp_lane_yield_pct.render": "program_counter",
                  "encode_lane_yield_pct.render": "program_counter", "block_host_ms.render": "program_span"},
}


def test_every_source_is_one_the_contract_names():
    assert {m["source"] for m in M["per_layer"]} <= SOURCES
    assert {m["source"] for m in M["end_to_end"]} <= {"host_clock", "device_trace"}


@pytest.mark.parametrize("cell", list(PROGRAM_METRICS))
def test_program_metrics_are_declared_for_their_cell(cell):
    entries = {m["name"]: m for m in mf.cell_metrics(M, cell, "per_layer")}
    for name, source in PROGRAM_METRICS[cell].items():
        m = entries[name]
        assert m["source"] == source and cell in m["workloads"]
        assert m["moves"] == ("frame_ms" if cell == "mv_replay" else "render_ms")


@pytest.mark.parametrize("new,old", [("decode_ms.train", "input_wait_ms.train"),
                                     ("idle_under_decode_pct.train", "input_wait_ms.train"),
                                     ("issue_ms.train", "launches_per_frame.train"),
                                     ("sync_wait_ms.train", "launches_per_frame.train"),
                                     ("block_host_ms.render", "mfu_pct.render")])
def test_a_layer_the_manifest_names_keeps_its_name(new, old):
    layer = {m["name"]: m["layer"] for m in M["per_layer"]}
    assert layer[new] == layer[old]


class _NoEntries:
    calls = []

    def totals(self):
        return {}


@contextlib.contextmanager
def _host_only_window(traced, *args):
    if not traced:
        yield None, None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof, _NoEntries()


@pytest.mark.parametrize("cell", list(PROGRAM_METRICS))
def test_a_traced_tiny_run_reads_every_program_metric(cell, tmp_path, monkeypatch):
    from neural_graph_mapping_tpu_torch.utils import profiling

    monkeypatch.setattr(run, "CACHE", tmp_path)
    monkeypatch.setattr(run, "traced_window", _host_only_window)
    monkeypatch.setattr(spans, "trace_path", lambda workload: tmp_path / f"trace-{workload}.json")
    profiling.reset()
    spans._memo.clear()
    cfg, wl = tiny_cell(cell)
    wl["trace_seconds"] = 1
    res = run.run_cell(cell, cfg, wl, M, 2**31 + 5, 1.0, True, "cpu", time.perf_counter())
    profiling.reset()
    assert res["correct"] is True
    for name in PROGRAM_METRICS[cell]:
        assert res["metrics"][name]["value"] > 0, name
    for name in ("idle_under_decode_pct.train", "mlp_lane_yield_pct.render", "encode_lane_yield_pct.render"):
        if name in res["metrics"]:
            assert res["metrics"][name]["value"] <= 100.0
    (red,) = spans._memo.values()
    assert red["coverage"]["frame_children" if cell == "mv_replay" else "render_blocks"] > 0.9


class _Tracer:
    def __init__(self, counters):
        self._counters = counters

    def recorded_spans(self):
        return []

    def counters(self):
        return dict(self._counters)


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur}


def _sv_frames(eager: bool, replayed: bool) -> list:
    """Two single-view frames in a [0, 1000] us window: frame 0's iteration
    eager (the sampler's three spans in ``ngm.iter.sample``), frame 1's
    replayed (``ngm.iter.sample`` launches a graph whose two kernels take
    30 us; ``ngm.iter.render`` launches one of 70 us)."""
    ev = [_x("port_bench.window", 0, 1000)]
    if eager:
        ev += [_x("ngm.frame.process", 10, 480), _x("ngm.iter.sample", 100, 200), _x("ngm.iter.sv_cloud", 100, 20),
               _x("ngm.iter.sv_count", 150, 100), _x("ngm.iter.sv_rays", 250, 40)]
    if replayed:
        ev += [_x("ngm.frame.process", 510, 480), _x("ngm.iter.sample", 600, 30), _x("ngm.iter.render", 630, 100),
               _launch(610, 7), _launch(640, 8), _kernel(650, 10, 7), _kernel(700, 20, 7), _kernel(720, 70, 8),
               _kernel(800, 5, 9)]
    return ev


def _launch(ts, correlation):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 1, "tid": 1, "ts": ts, "dur": 5,
            "args": {"correlation": correlation}}


def _kernel(ts, dur, correlation):
    return {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": correlation}}


@pytest.mark.parametrize("eager,replayed,counters,want", [
    (False, True, {"sv.slots": 64, "step.graphed": 5, "step.iterations": 5}, 1e3 * 30e-6 / 2),
    (False, True, {"sv.slots": 64, "step.graphed": 4, "step.iterations": 5}, 1e3 * 30e-6 / 4 * 5 / 2),
    (True, True, {"sv.slots": 64, "step.graphed": 5, "step.iterations": 10}, 1e3 * 30e-6 / 5 * 10 / 2),
    (True, False, {"sv.slots": 64}, 1e3 * 160e-6 / 2),
    (False, True, {"step.graphed": 5, "step.iterations": 5}, None),  # multi-view: no sampler counted
    (False, True, {"sv.slots": 64}, None),  # graphs, but no iteration counted
    (False, False, {"sv.slots": 64}, None),  # neither spans nor graphs
])
def test_the_sample_stage_reads_replayed_device_time_or_eager_spans(tmp_path, monkeypatch, eager, replayed, counters,
                                                                    want):
    """``sv_sample_ms.train``: the device time that the graph launches in
    ``ngm.iter.sample`` replay, a replayed iteration, times the iterations a
    frame; without such launches, the eager sampler's spans, ms a frame."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _sv_frames(eager, replayed)}))
    monkeypatch.setattr(spans, "trace_path", lambda workload: path)
    monkeypatch.setattr(spans, "program_tracer", lambda: _Tracer(counters))
    spans._memo.clear()
    r = {"workload": "w", "frames": 2, "images": 0, "window_s": 1e-3, "entries": {}, "trace": {}, "phase_s": None}
    got = mf.load_reader("sv_sample_ms.train").read(r)
    assert got == (None if want is None else pytest.approx(want))
    (red,) = spans._memo.values()
    if replayed:
        assert red["graph_device_s"] == {"ngm.iter.sample": pytest.approx(30e-6), "ngm.iter.render": pytest.approx(70e-6)}
    spans._memo.clear()
