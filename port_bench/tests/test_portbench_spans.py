"""The per-layer metrics read from the program's own spans and counters
(``port_bench/spans.py``): their manifest entries, and a traced run of each
cell at a tiny size on the CPU, the profiler recording host activity only
(no device, so no entry markers), in which every one of them reads."""

import contextlib
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
        assert m["source"] == source and m["workloads"] == [cell]
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
