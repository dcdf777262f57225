"""BENCHMARK.json against the contract's shape, and against the files it names."""

import json
import shutil

import pytest

from port_bench import manifest as mf

M = mf.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(M) == TOP_KEYS
    assert M["command"] == ["python3", "-m", "port_bench"]
    assert M["paths"] == ["port_bench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    for e in M[kind]:
        assert mf.NAME_RE.match(e["name"]), e["name"]
        if "unit" in e:
            assert mf.UNIT_RE.match(e["unit"]), e["unit"]
            assert len(e["unit"]) <= 16
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/") and mf.load_config(c["name"])["source"] == c["source"]
        assert all(mf.NAME_RE.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert mf.load_workload(w["traffic"])["config"] == w["config"]
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        e2e = [m["name"] for m in mf.cell_metrics(M, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.cell_metrics(M, w["name"], "per_layer")


def test_per_layer_cells_report_what_the_metric_moves():
    for m in M["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in M["workloads"]]):
            assert m["moves"] in [e["name"] for e in mf.cell_metrics(M, cell, "end_to_end")], (m["name"], cell)


def test_readers_declare_what_the_manifest_says():
    for m in M["per_layer"]:
        r = mf.load_reader(m["name"])
        assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES, r.WORKLOADS) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"], m["workloads"])
        assert r.read({"frames": 0, "images": 0, "entries": {}, "trace": {}, "phase_s": None}) is None


def test_a_new_workload_file_is_found_without_a_code_edit(tmp_path, monkeypatch):
    root = tmp_path / "port_bench"
    shutil.copytree(mf.HERE, root, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "workloads" / "mv_live_short.json").write_text(json.dumps(dict(mf.load_workload("mv_replay"),
                                                                           input="memory")))
    manifest = dict(M, workloads=M["workloads"] + [dict(M["workloads"][0], name="mv_live_short",
                                                        traffic="mv_live_short")])
    monkeypatch.setattr(mf, "HERE", root)
    assert mf.load_workload("mv_live_short")["input"] == "memory"
    assert mf.cell_entry(manifest, "mv_live_short")["config"] == "ngm_multiview_640"
    assert [m["name"] for m in mf.cell_metrics(manifest, "mv_live_short", "end_to_end")] == ["setup_s"]
