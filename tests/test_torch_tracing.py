"""The port's tracer (utils/profiling.py): spans and counters on while a
profiler records, where the program puts them, what they cost when off, and the
benchmark's readers of them (port_bench/spans.py, port_bench/metrics/)
on hand-made traces."""

import json
import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch
from torch.profiler import ProfilerActivity, profile

from neural_graph_mapping_tpu_torch import geometry
from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, sampling
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import dispatch, permuto_cuda
from neural_graph_mapping_tpu_torch.utils import imageio, profiling, transforms
from neural_graph_mapping_tpu_torch.utils.prefetch import FramePrefetcher
from port_bench import manifest as mf
from port_bench import spans

PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
_TRACING_ON = profiling.tracing_on
DS_CFG = {"num_frames": 12, "width": 40, "height": 30, "fx": 35.0, "fy": 35.0}
FIELD_KW = dict(
    dim_points=3, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
    field_kwargs=dict(
        encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
        encoding_kwargs=dict(pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
                             coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2),
        num_layers=1, dim_out=4),
    num_knn=2, distance_factor=10.0, field_radius=1.0, scale_mode="unit_cube", outside_value=1.0,
)


def tiny_config(**overrides):
    cfg = {
        "model_kwargs": FIELD_KW, "field_radius": 1.0, "num_train_fields": 4, "num_rays_per_field": 32,
        "num_samples_coarse": 4, "num_samples_depth_guided": 8, "num_iterations_per_frame": 2,
        "num_kf_slots": 8, "max_new_fields": 64, "geometry_mode": "nrgbd", "geometry_factor": 20.0,
        "truncation_distance": 0.1, "learning_rate": 1e-3, "adam_eps": 1e-15, "adam_weight_decay": 1e-5,
        "eval_span_samples": 32, "pixel_block_size": 64,
    }
    cfg.update(overrides)
    return cfg


@pytest.fixture(autouse=True)
def tracer_state():
    profiling.reset()
    spans._memo.clear()
    yield
    profiling.reset()
    spans._memo.clear()


def _trace(monkeypatch, on):
    """Spans and counters on or off, with no profiler recording: kept spans
    only (a span is a ``record_function`` range only under a profiler)."""
    monkeypatch.setattr(profiling, "tracing_on", lambda: on)


@pytest.fixture(scope="module")
def dataset():
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    return ds


def _forbid_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)


def _run_map(ds, frames=4, render=True):
    """A tiny map's frames and one 16x12 render -> (losses, params, render, phase keys)."""
    ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
    losses = [ngm.process_frame(ds, f, ds[f]["rgbd"]) for f in range(frames)]
    rgbd = ngm.render_image(ds[1]["c2w"], ds.camera.scaled_camera(0.4))[0] if render else None
    return losses, ngm._params, rgbd, sorted(ngm.phase_times)


# -- on while a profiler records ---------------------------------------------------


@pytest.mark.parametrize("off", ["no_profiler", "after_a_profiler"])
def test_off_span_is_the_shared_noop_and_counts_nothing(monkeypatch, off):
    if off == "after_a_profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            pass
    _forbid_record_function(monkeypatch)
    assert not profiling.tracing_on()
    a, b = profiling.span("ngm.frame.step", frame=3), profiling.span("ngm.render.block")
    assert a is b is profiling._NO_SPAN
    with a:
        profiling.count("render.lanes_mlp", 1024)
        profiling.count("render.pairs_valid", torch.tensor(5))
    assert profiling.counters() == {} and profiling.recorded_spans() == []


@pytest.mark.parametrize("api", ["torch.profiler", "autograd.profiler", "nested"])
def test_the_tracer_follows_the_profiler(api):
    assert not profiling.tracing_on()
    if api == "torch.profiler":
        ctx = profile(activities=[ProfilerActivity.CPU])
    elif api == "autograd.profiler":
        ctx = torch.autograd.profiler.profile()
    else:
        ctx = profile(activities=[ProfilerActivity.CPU], record_shapes=True)
    with ctx as prof:
        assert profiling.tracing_on()
        with profiling.span("ngm.frame.step", frame=7):
            if api == "nested":
                with profiling.span("ngm.frame.sync"):
                    pass
    assert not profiling.tracing_on()
    events = prof.function_events if api == "autograd.profiler" else prof.events()
    names = [e.name for e in events if e.name.startswith("ngm.")]
    assert names == (["ngm.frame.step", "ngm.frame.sync"] if api == "nested" else ["ngm.frame.step"])
    assert profiling.recorded_spans() == []  # the profiled thread's spans are the profiler's


def test_untraced_frames_and_render_call_no_record_function(monkeypatch, dataset):
    _forbid_record_function(monkeypatch)
    losses, _, rgbd, keys = _run_map(dataset, frames=3)
    assert losses[-1] and bool(torch.isfinite(rgbd).all())
    assert keys == ["alloc", "graph", "host_misc"]
    assert profiling.counters() == {} and profiling.recorded_spans() == []


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("what", ["frames", "render"])
def test_tensor_ops_on_and_off(monkeypatch, dataset, what):
    """Spans issue no tensor operation; only the render's device counters
    add some, and only while tracing: an untraced call runs the same
    operations as with the tracer's calls removed."""
    counts = {}
    for mode in (False, True):
        _trace(monkeypatch, mode)
        ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
        ngm.process_frame(dataset, 0, dataset[0]["rgbd"])
        with _OpCounter() as c:
            if what == "frames":
                ngm.process_frame(dataset, 1, dataset[1]["rgbd"])
            else:
                ngm.render_image(dataset[1]["c2w"], dataset.camera.scaled_camera(0.4))
        counts[mode] = c.ops
    if what == "frames":
        assert counts[True] == counts[False]
    else:
        assert counts[True] > counts[False]


def test_traced_and_untraced_runs_are_bit_identical(monkeypatch, dataset):
    _trace(monkeypatch, False)
    off = _run_map(dataset)
    _trace(monkeypatch, True)
    on = _run_map(dataset)
    assert off[0] == on[0] and off[3] == on[3]
    for k, v in off[1].items():
        assert torch.equal(v, on[1][k]), k
    assert torch.equal(off[2], on[2])
    c = profiling.counters()
    assert c["render.lanes_mlp"] >= c["render.lanes_encoded"] >= c["render.pairs_valid"] > 0


# -- spans in a profiler's trace --------------------------------------------------


class _PngDataset:
    """The synthetic frames, each read after decoding a PNG written beside
    them (the prefetch worker's read and decode)."""

    def __init__(self, ds, path):
        self._ds, self._path = ds, path
        imageio.write_png(path, (np.arange(48 * 4).reshape(48, 4) % 251).astype(np.uint8))

    def __getitem__(self, fid):
        imageio.read_png(self._path)
        return self._ds[fid]


def _events_by_name(trace):
    out = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("ngm."):
            out.setdefault(e["name"], []).append(e)
    return out


def _inside(child, parent):
    return (parent["tid"] == child["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3)


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory, dataset):
    """Three frames from the prefetcher and one render under a CPU profiler,
    the tracer following it -> (trace with the worker's spans merged, main tid)."""
    profiling.reset()
    tmp = tmp_path_factory.mktemp("trace")
    ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
    source = _PngDataset(dataset, tmp / "f.png")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pf = FramePrefetcher(source, range(3), depth=2)
        try:
            for f in range(3):
                ngm.process_frame(dataset, f, pf.get(f)["rgbd"])
        finally:
            pf.close()
        ngm.render_image(dataset[1]["c2w"], dataset.camera.scaled_camera(0.4))
    prof.export_chrome_trace(str(tmp / "t.json"))
    trace = json.loads((tmp / "t.json").read_text())
    recorded = profiling.recorded_spans()
    counters = profiling.counters()
    spans.merge_recorded(trace, recorded)
    profiling.reset()
    return trace, threading.get_native_id(), counters


def test_frame_spans_nest_as_listed(traced_run):
    trace, main, _ = traced_run
    ev = _events_by_name(trace)
    frames = ev["ngm.frame.process"]
    assert len(frames) == 3 and all(e["tid"] == main for e in frames)
    for name in ("ngm.frame.graph", "ngm.frame.alloc", "ngm.frame.host_misc", "ngm.frame.step"):
        assert len(ev[name]) == 3 and all(any(_inside(e, f) for f in frames) for e in ev[name]), name
    steps = ev["ngm.frame.step"]
    for name in ("ngm.frame.cache_write", "ngm.frame.observed", "ngm.frame.sync", "ngm.iter.select",
                 "ngm.iter.sample", "ngm.iter.gather", "ngm.iter.render", "ngm.iter.loss",
                 "ngm.iter.backward", "ngm.iter.adam"):
        assert ev[name] and all(any(_inside(e, s) for s in steps) for e in ev[name]), name
    assert len(ev["ngm.iter.backward"]) == 3 * 2  # frame 0 allocates before its step: all train twice


def test_render_spans_nest_as_listed(traced_run):
    trace, main, _ = traced_run
    ev = _events_by_name(trace)
    (image,) = ev["ngm.render.image"]
    blocks = ev["ngm.render.block"]
    assert len(blocks) == 3 and all(_inside(b, image) for b in blocks)  # 192 rays in blocks of 64
    for name in ("ngm.render.span", "ngm.render.route", "ngm.render.dispatch", "ngm.render.encode",
                 "ngm.render.scatter_blend", "ngm.render.composite"):
        assert len(ev[name]) == 3 and all(any(_inside(e, b) for b in blocks) for e in ev[name]), name
    assert "ngm.render.mlp" not in ev  # the tiny map's MLP runs in the encode


def test_input_spans_sit_on_the_worker_thread(traced_run):
    trace, main, counters = traced_run
    ev = _events_by_name(trace)
    assert all(e["tid"] == main for e in ev["ngm.input.wait"]) and len(ev["ngm.input.wait"]) == 3
    reads = ev["ngm.input.read"]
    worker = {e["tid"] for e in reads}
    assert len(worker) == 1 and main not in worker
    assert all(any(_inside(d, r) for r in reads) for d in ev["ngm.input.decode"])
    # the CPU trains eagerly: iterations counted, none from graphs
    assert set(counters) == {"render.pairs_valid", "render.lanes_encoded", "render.lanes_mlp", "render.mlp_fused",
                             "step.iterations"}
    assert counters["render.mlp_fused"] == 3
    assert counters["step.iterations"] == 3 * 2


SV_SPANS = ("ngm.iter.sv_cloud", "ngm.iter.sv_count", "ngm.iter.sv_rays")


@pytest.fixture(scope="module")
def traced_sv_run(dataset):
    """A single-view map's first three frames (two with fields) under a CPU
    profiler, the tracer following it -> (trace, counters)."""
    profiling.reset()
    ngm = engine.NeuralGraphMap(tiny_config(update_mode="single_view"), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in range(3):
            ngm.process_frame(dataset, f, dataset[f]["rgbd"])
    trace = _export(prof)
    counters = profiling.counters()
    profiling.reset()
    return trace, counters


def test_single_view_sampler_spans_nest_in_sample(traced_sv_run):
    trace, counters = traced_sv_run
    ev = _events_by_name(trace)
    samples = ev["ngm.iter.sample"]
    assert len(samples) == 3 * 2  # frame 0 allocates before its step
    for name in SV_SPANS:
        assert all(any(_inside(e, s) for s in samples) for e in ev[name]), name
    assert [len(ev[n]) for n in SV_SPANS] == [2 * 6, 6, 6]  # the view in the engine, its cloud in the sampler
    covered = sum(e["dur"] for n in SV_SPANS for e in ev[n]) / sum(e["dur"] for e in samples)
    assert 0.9 < covered <= 1.0
    assert counters["sv.slots"] == 6 * 4 and 0 < counters["sv.slots_valid"] <= counters["sv.slots"]
    assert counters["sv.fields_eligible"] >= counters["sv.slots_valid"]


@pytest.mark.parametrize("active_fields", [None, 2])
def test_single_view_counters_against_the_iteration(monkeypatch, active_fields):
    """The sampler's counters equal its own target's filled slots and a
    direct count of the fields that at least R cloud segments reach."""
    from port_bench import scene

    sc = {"width": 40, "height": 30, "fx": 35.0, "fy": 35.0, "lap_frames": 40, "orbit_radius": 2.5, "room_half": 3.0}
    frames, poses = scene.cast_lap(sc, "cpu", [7])
    rgbd, c2w = torch.from_numpy(frames[7]), torch.from_numpy(poses[7])
    cam = Camera.create(width=40, height=30, fx=35.0, fy=35.0, cx=20.0, cy=15.0)
    g = torch.Generator().manual_seed(3)
    positions = (torch.rand((48, 3), generator=g) * 2.0 - 1.0) * 2.5
    active = torch.ones(48, dtype=torch.bool)
    if active_fields is not None:
        active[active_fields:] = False
    f, r, points = 4, 16, 2_000
    cloud_idx = torch.randint(0, 40 * 30, (points,), generator=g)
    _trace(monkeypatch, True)
    target = sampling.sample_target_sv(cam, rgbd, c2w, positions, active, 1.0, f, r, num_cloud_points=points,
                                       cloud_idx=cloud_idx, u_fields=torch.rand(48, generator=g),
                                       u_rays=torch.rand((f, r), generator=g))
    pts, _, ok = cam.depth_to_points_full(rgbd[..., 3], "opengl")
    centres = transforms.transform_points(positions, c2w, inv=True)
    hits = geometry.segments_intersect_spheres(torch.zeros_like(pts[cloud_idx]), pts[cloud_idx], centres, 1.0)
    eligible = ((hits & ok[cloud_idx][None, :]).sum(-1) >= r) & active
    assert profiling.counters() == {"sv.slots_valid": int(target.field_valid.sum()), "sv.slots": f,
                                    "sv.fields_eligible": int(eligible.sum())}
    assert (int(target.field_valid.sum()) < f) == (active_fields is not None)


def test_untraced_single_view_frames_record_nothing(monkeypatch, dataset):
    _forbid_record_function(monkeypatch)
    ngm = engine.NeuralGraphMap(tiny_config(update_mode="single_view"), "cpu")
    losses = [ngm.process_frame(dataset, f, dataset[f]["rgbd"]) for f in range(3)]
    assert losses[-1] and all(np.isfinite(v) for v in losses[-1].values())
    assert profiling.counters() == {} and profiling.recorded_spans() == []


def test_a_traced_tiny_sv_replay_run_reads_its_metrics(tmp_path, monkeypatch):
    """The benchmark's single-view cell at a tiny size on the CPU, traced
    (host activity only): both of its per-layer metrics read, and the three
    sampler spans cover nearly all of ``ngm.iter.sample``."""
    import contextlib

    from port_bench import run
    from port_bench.tests.tiny import tiny_cell

    class NoEntries:
        calls = []

        def totals(self):
            return {}

    @contextlib.contextmanager
    def host_only(traced, *args):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof, NoEntries()

    monkeypatch.setattr(run, "CACHE", tmp_path)
    monkeypatch.setattr(run, "traced_window", host_only)
    monkeypatch.setattr(spans, "trace_path", lambda workload: tmp_path / f"trace-{workload}.json")
    cfg, wl = tiny_cell("sv_replay")
    wl["trace_seconds"] = 1
    res = run.run_cell("sv_replay", cfg, wl, mf.load_manifest(), 2**31 + 7, 1.0, True, "cpu", time.perf_counter())
    assert res["correct"] is True
    assert res["metrics"]["sv_sample_ms.train"]["value"] > 0
    assert 0 < res["metrics"]["sv_slot_yield_pct.train"]["value"] <= 100.0
    (red,) = spans._memo.values()
    sv = sum(red["spans"][n]["s"] for n in SV_SPANS)
    assert 0.9 < sv / red["spans"]["ngm.iter.sample"]["s"] <= 1.0


def test_kept_spans_share_the_trace_clock(traced_run):
    """A span the tracer keeps itself lands on the trace's clock: a kept
    span opened inside a profiled range falls inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("ngm.frame.step"):
            time.sleep(0.02)
            t = threading.Thread(target=lambda: profiling.span("ngm.input.read").__enter__().__exit__())
            t.start()
            t.join(timeout=5)
            time.sleep(0.02)
    assert not t.is_alive()
    trace = _export(prof)
    spans.merge_recorded(trace, profiling.recorded_spans())
    ev = _events_by_name(trace)
    (step,), (read,) = ev["ngm.frame.step"], ev["ngm.input.read"]
    assert step["ts"] + 5e3 <= read["ts"] <= step["ts"] + step["dur"] - 5e3


def _export(prof):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/t.json")
        return json.loads(pathlib.Path(f"{d}/t.json").read_text())


# -- counters ---------------------------------------------------------------------


def _spied_dispatches(monkeypatch, field_kw, num_fields, num_points):
    """Two traced apply_knn_tiled calls -> (counters, [(valid pairs, live
    tiles, tiles)] of their dispatches)."""
    fset = NeuralFieldSet(**field_kw)
    gen = torch.Generator().manual_seed(num_fields)
    params = fset.init_fields(num_fields, gen, "cpu")
    pos = torch.randn((num_fields, 3), generator=gen) * 1.5
    q = torch.randn((num_fields, 4), generator=gen)
    quat = q / q.norm(dim=-1, keepdim=True)
    valid = torch.arange(num_fields) < num_fields - 2
    pts = torch.randn((num_points, 3), generator=gen) * 2
    seen = []
    real = dispatch.tiled_dispatch_sorted

    def spy(expert_ids, pair_valid, payloads, num_experts, tile):
        out = real(expert_ids, pair_valid, payloads, num_experts, tile)
        seen.append((int(pair_valid.sum()), int(out[5]), out[6]))
        return out

    dispatch.tiled_dispatch_sorted = spy
    try:
        _trace(monkeypatch, True)
        fset.apply_knn_tiled(params, pts, pos, quat, valid)
        fset.apply_knn_tiled(params, pts[: num_points // 2], pos, quat, valid)
    finally:
        dispatch.tiled_dispatch_sorted = real
    return profiling.counters(), seen


@pytest.mark.parametrize("num_fields,num_points", [(6, 500), (16, 3000)])
def test_render_counters_against_the_dispatch(monkeypatch, num_fields, num_points):
    """The encode runs the MLP: the MLP's lanes are the encode's, and each
    dispatch counts once in ``render.mlp_fused``."""
    c, seen = _spied_dispatches(monkeypatch, FIELD_KW, num_fields, num_points)
    tile = permuto_cuda.TILE
    assert c["render.pairs_valid"] == sum(s[0] for s in seen) > 0
    assert c["render.lanes_encoded"] == sum(s[1] * tile for s in seen)
    assert c["render.lanes_mlp"] == c["render.lanes_encoded"]
    assert c["render.mlp_fused"] == len(seen) == 2


def test_render_counters_on_a_fallback_mlp(monkeypatch):
    """An MLP the encode does not run (two hidden layers): ``mlp_fm`` runs
    over every tile of the dispatch, and no dispatch counts as fused."""
    field_kw = dict(FIELD_KW, field_kwargs=dict(FIELD_KW["field_kwargs"], num_layers=2))
    c, seen = _spied_dispatches(monkeypatch, field_kw, 6, 500)
    tile = permuto_cuda.TILE
    assert c["render.lanes_encoded"] == sum(s[1] * tile for s in seen)
    assert c["render.lanes_mlp"] == sum(s[2] * tile for s in seen) > c["render.lanes_encoded"]
    assert "render.mlp_fused" not in c


def test_device_counters_accumulate_past_int32(monkeypatch):
    _trace(monkeypatch, True)
    for _ in range(3):
        profiling.count("render.pairs_valid", torch.tensor(2**30, dtype=torch.int32))
    profiling.count("render.lanes_mlp", 1)
    profiling.count("render.lanes_mlp", 2)
    assert profiling.counters() == {"render.pairs_valid": 3 * 2**30, "render.lanes_mlp": 3}


def test_prefetcher_counts_a_synchronous_fallback(monkeypatch):
    """A read off the prefetcher's schedule is served on the calling thread,
    and its span sits there."""
    _trace(monkeypatch, True)
    reads = []

    class Ds:
        def __getitem__(self, fid):
            reads.append(fid)
            return {"rgbd": np.zeros((2, 2, 4), np.float32)}

    pf = FramePrefetcher(Ds(), [0, 1], depth=2)
    try:
        pf.get(0)
        pf.get(5)  # not the next expected id
    finally:
        pf.close()
    assert reads.count(5) == 1
    main = [s for s in profiling.recorded_spans() if s[1] == threading.current_thread().native_id]
    assert [(s[0], s[4]) for s in main] == [("ngm.input.wait", {"frame": 0}), ("ngm.input.read", {"frame": 5})]


# -- phases and the decorator -------------------------------------------------------


@pytest.mark.parametrize("mode", [False, True])
def test_phase_always_adds_its_time(monkeypatch, mode):
    _trace(monkeypatch, mode)
    into = {"graph": 1.0}
    with profiling.phase("graph", into=into):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with profiling.phase("alloc", into=into):
            raise ValueError
    assert into["graph"] >= 1.01 and "alloc" in into
    assert [s[0] for s in profiling.recorded_spans()] == (["ngm.frame.graph", "ngm.frame.alloc"] if mode else [])


@pytest.mark.parametrize("prints", [False, True])
def test_render_image_opens_its_span_under_the_decorator(monkeypatch, capsys, dataset, prints):
    ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
    ngm.process_frame(dataset, 0, dataset[0]["rgbd"])
    _trace(monkeypatch, True)
    profiling.reset()
    profiling.benchmark.enabled = prints
    try:
        rgbd = ngm.render_image(dataset[1]["c2w"], dataset.camera.scaled_camera(0.4))[0]
    finally:
        profiling.benchmark.enabled = False
    assert bool(torch.isfinite(rgbd).all())
    names = [s[0] for s in profiling.recorded_spans()]
    assert names[-1] == "ngm.render.image" and names.count("ngm.render.block") == 3
    assert ("render_image finished" in capsys.readouterr().out) is prints


# -- the registries -----------------------------------------------------------------

_USE = re.compile(r'\b(span|phase|count)\(\s*(f?)"([^"]+)"')


def _uses():
    out = {"span": set(), "count": set()}
    for path in PACKAGE.rglob("*.py"):
        for kind, fmt, name in _USE.findall(path.read_text()):
            if fmt:
                continue  # phase's own f-string
            if kind == "phase":
                out["span"].add(f"ngm.frame.{name}")
            elif kind == "span":
                out["span"].add(name)
            else:
                out["count"].add(name)
    return out


@pytest.mark.parametrize("kind,registry", [("span", profiling.SPANS), ("count", profiling.COUNTERS)])
def test_every_name_used_is_registered_and_every_registered_name_used(kind, registry):
    used = _uses()[kind]
    assert used and used <= set(registry), used - set(registry)
    assert set(registry) <= used, set(registry) - used
    pattern = r"ngm\.[a-z]+\.[a-z0-9_]+" if kind == "span" else r"[a-z]+\.[a-z_]+"
    assert [n for n in registry if not re.fullmatch(pattern, n)] == []


# -- the benchmark's reduction and readers on hand-made traces ------------------------

MAIN, WORKER = 100, 200


def _x(name, ts, dur, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}


def _hand_trace():
    """A window [0, 1000] us with two frames; device busy [100, 300] and
    [600, 700]; the worker decodes over [250, 650]."""
    ev = [_x("port_bench.window", 0, 1000)]
    for f0 in (0, 500):
        ev += [_x("ngm.frame.process", f0 + 10, 480), _x("ngm.frame.graph", f0 + 10, 20),
               _x("ngm.frame.alloc", f0 + 30, 20), _x("ngm.frame.host_misc", f0 + 50, 20),
               _x("ngm.frame.step", f0 + 70, 410), _x("ngm.iter.render", f0 + 80, 100),
               _x("ngm.frame.sync", f0 + 300, 180)]
    ev += [_x("ngm.input.read", 240, 420, WORKER), _x("ngm.input.decode", 250, 400, WORKER)]
    ev += [_x("k", 100, 200, 7, "kernel"), _x("k", 600, 100, 7, "kernel")]
    ev += [_x("cudaLaunchKernel", t, 1, MAIN, "cuda_runtime") for t in (90, 95, 590, 995)]
    ev += [_x("cudaLaunchKernel", t, 1, 300, "cuda_runtime") for t in (5, 200)]  # autograd's thread
    return ev


def test_innermost_segments_of_nested_spans():
    pieces = spans.innermost_segments([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (5, 8, "d")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"), (5, 8, "d"), (8, 10, "a")]


def test_idle_by_span_on_a_hand_made_trace():
    red = spans.reduce_spans(_hand_trace())
    idle = red["idle_by_span"]
    # idle: [0,100], [300,600], [700,1000] = 700 us
    assert idle["idle_s"] == pytest.approx(700e-6)
    main = {k: round(v * 1e6, 6) for k, v in idle["main"].items()}
    assert main == {spans.NO_SPAN: 40.0, "ngm.frame.graph": 40.0, "ngm.frame.alloc": 40.0,
                    "ngm.frame.host_misc": 40.0, "ngm.frame.step": 120.0, "ngm.iter.render": 40.0,
                    "ngm.frame.sync": 360.0, "ngm.frame.process": 20.0}
    assert idle["other"] == {"ngm.input.decode": pytest.approx(300e-6), "ngm.input.read": pytest.approx(300e-6)}
    assert idle["gaps"][0] == ["ngm.frame.sync", pytest.approx(300e-6)]
    assert red["spans"]["ngm.frame.step"] == {"s": pytest.approx(820e-6), "n": 2}
    cov = red["coverage"]
    assert cov["launches"] == 6 and cov["launches_off_main"] == 2 and cov["launches_in_span"] == 4 / 6
    assert cov["frame_children"] == pytest.approx(470 / 480) and cov["render_blocks"] is None


class _FakeTracer:
    def __init__(self, recorded=(), counters=None):
        self._recorded, self._counters = list(recorded), dict(counters or {})

    def recorded_spans(self):
        return list(self._recorded)

    def counters(self):
        return dict(self._counters)


READERS = {
    # name: (kind, expected value)
    "decode_ms.train": ("frames", 1e3 * 400e-6 / 2),
    "idle_under_decode_pct.train": ("frames", 100 * 300 / 700),
    "issue_ms.train": ("frames", 1e3 * (820e-6 - 360e-6) / 2),
    "sync_wait_ms.train": ("frames", 1e3 * 360e-6 / 2),
    "mlp_lane_yield_pct.render": ("images", 100 * 300 / 1024),
    "encode_lane_yield_pct.render": ("images", 100 * 300 / 512),
    "block_host_ms.render": ("images", 1e3 * 600e-6 / 3),
    "sv_sample_ms.train": ("sv_frames", 1e3 * 2 * (20 + 20 + 100 + 40) * 1e-6 / 2),
    "sv_slot_yield_pct.train": ("sv_frames", 100 * 50 / 64),
    "graph_iter_pct.train": ("frames", 100 * 9 / 10),
}
SV_COUNTERS = {"sv.slots_valid": 50, "sv.slots": 64, "sv.fields_eligible": 7}
STEP_COUNTERS = {"step.iterations": 10, "step.graphed": 9}


def _hand_render_trace():
    ev = [_x("port_bench.window", 0, 1000), _x("ngm.render.image", 50, 900)]
    ev += [_x("ngm.render.block", 60 + 300 * i, 200) for i in range(3)]
    return ev


def _hand_sv_trace():
    """Two single-view frames; each one's sampling [100, 300] us into the
    frame, its view and cloud, counts and rays inside it."""
    ev = [_x("port_bench.window", 0, 1000)]
    for f0 in (0, 500):
        ev += [_x("ngm.frame.process", f0 + 10, 480), _x("ngm.frame.step", f0 + 50, 430),
               _x("ngm.iter.sample", f0 + 100, 200), _x("ngm.iter.sv_cloud", f0 + 100, 20),
               _x("ngm.iter.sv_cloud", f0 + 130, 20), _x("ngm.iter.sv_count", f0 + 150, 100),
               _x("ngm.iter.sv_rays", f0 + 250, 40)]
    return ev


def _reading(tmp_path, monkeypatch, kind, tracer):
    events = {"frames": _hand_trace, "images": _hand_render_trace, "sv_frames": _hand_sv_trace}[kind]()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "trace_path", lambda workload: path)
    monkeypatch.setattr(spans, "program_tracer", lambda: tracer)
    return {"workload": "w", "frames": 0 if kind == "images" else 2, "images": 3 if kind == "images" else 0,
            "window_s": 1e-3, "entries": {}, "trace": {}, "phase_s": None}


@pytest.mark.parametrize("name", list(READERS))
def test_each_new_reader_on_a_hand_made_trace(tmp_path, monkeypatch, name):
    kind, want = READERS[name]
    counters = {"render.pairs_valid": 300, "render.lanes_encoded": 512, "render.lanes_mlp": 1024, **SV_COUNTERS,
                **STEP_COUNTERS}
    r = _reading(tmp_path, monkeypatch, kind, _FakeTracer(counters=counters))
    assert mf.load_reader(name).read(r) == pytest.approx(want)


@pytest.mark.parametrize("counters,want", [({}, None), ({"step.graphed": 3}, None), ({"step.iterations": 8}, 0.0)])
def test_graph_share_reads_nothing_without_iterations_and_zero_without_graphs(tmp_path, monkeypatch, counters, want):
    """No iteration counted (a program before the counters): None, no error;
    iterations and none from graphs: 0."""
    r = _reading(tmp_path, monkeypatch, "frames", _FakeTracer(counters=counters))
    assert mf.load_reader("graph_iter_pct.train").read(r) == want


@pytest.mark.parametrize("name,missing", [("sv_sample_ms.train", "frames"), ("sv_sample_ms.train", "ngm.iter.sv_rays"),
                                          ("sv_sample_ms.train", "multi_view"),
                                          ("sv_slot_yield_pct.train", "frames"),
                                          ("sv_slot_yield_pct.train", "sv.slots"),
                                          ("sv_slot_yield_pct.train", "sv.slots_valid")])
def test_single_view_readers_read_nothing_without_their_frames_spans_or_counters(tmp_path, monkeypatch, name,
                                                                                missing):
    """No frames, a span missing, a multi-view window (no sampler spans at
    all), or a counter missing: None, and no error."""
    counters = {k: v for k, v in SV_COUNTERS.items() if k != missing}
    r = _reading(tmp_path, monkeypatch, "sv_frames", _FakeTracer(counters=counters))
    if missing == "frames":
        r["frames"] = 0
    elif missing.startswith("ngm.") or missing == "multi_view":
        events = [e for e in _hand_sv_trace() if e["name"] == missing
                  or (missing == "multi_view" and e["name"].startswith("ngm.iter.sv_"))]
        kept = [e for e in _hand_sv_trace() if e not in events]
        spans.trace_path(r["workload"]).write_text(json.dumps({"traceEvents": kept}))
    assert mf.load_reader(name).read(r) is None


@pytest.mark.parametrize("name", list(READERS))
def test_each_new_reader_is_silent_without_the_tracer(tmp_path, monkeypatch, name):
    """A program without the tracer (the commit before it): no value, no error."""
    r = _reading(tmp_path, monkeypatch, READERS[name][0], None)
    assert mf.load_reader(name).read(r) is None


@pytest.mark.parametrize("name", list(READERS))
def test_each_new_reader_raises_without_the_exported_trace(tmp_path, monkeypatch, name):
    """The program has the tracer but the harness left no trace where
    ``spans.trace_path`` looks: an error, not a metric quietly left out."""
    r = _reading(tmp_path, monkeypatch, READERS[name][0], _FakeTracer())
    monkeypatch.setattr(spans, "trace_path", lambda workload: tmp_path / "elsewhere.json")
    with pytest.raises(FileNotFoundError, match="elsewhere.json"):
        mf.load_reader(name).read(r)


def test_worker_spans_merge_into_the_trace_once(tmp_path, monkeypatch):
    base_ns = 1_700_000_000_000_000_000
    rec = [("ngm.input.decode", WORKER, base_ns + 300_000, base_ns + 500_000, {"frame": 4})]
    trace = {"baseTimeNanoseconds": base_ns, "traceEvents": [_x("port_bench.window", 0, 1000)]}
    assert spans.merge_recorded(trace, rec) == 1 and spans.merge_recorded(trace, rec) == 0
    e = trace["traceEvents"][-1]
    assert (e["ts"], e["dur"], e["tid"], e["pid"], e["args"]) == (300.0, 200.0, WORKER, 1, {"frame": 4})


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernels_launched(monkeypatch, dataset, mode, what):
    """Kernels a tiny map's third frame (or a render) launches under a
    CUDA profiler, the tracer following it (``mode``) or held off. The
    first two frames record the frame step's CUDA graphs, so the third
    replays them."""
    monkeypatch.setattr(profiling, "tracing_on", _TRACING_ON if mode else (lambda: False))
    ngm = engine.NeuralGraphMap(tiny_config(), "cuda")
    for f in range(2):
        ngm.process_frame(dataset, f, dataset[f]["rgbd"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if what == "frames":
            ngm.process_frame(dataset, 2, dataset[2]["rgbd"])
        else:
            ngm.render_image(dataset[1]["c2w"], dataset.camera.scaled_camera(0.4))
        torch.cuda.synchronize()
    trace = _export(prof)
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    return sum(1 for e in trace["traceEvents"] if e.get("cat") == "kernel"), names


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["frames", "render"])
def test_on_the_card_spans_launch_no_kernel(monkeypatch, cuda, dataset, what):
    # the process's first profiled frame also records 19 of CUDA's own copy
    # kernels (memcpy32_post) beside the replayed graphs; later ones do not
    _kernels_launched(monkeypatch, dataset, False, what)
    off, off_names = _kernels_launched(monkeypatch, dataset, False, what)
    on, on_names = _kernels_launched(monkeypatch, dataset, True, what)
    assert not any(n.startswith("ngm.") for n in off_names)
    assert {"ngm.frame.step", "ngm.iter.backward"} <= on_names if what == "frames" else "ngm.render.encode" in on_names
    if what == "frames":
        assert on == off > 0
    else:
        assert on > off > 0
