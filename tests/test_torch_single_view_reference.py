"""The port's single-view sampler against the benchmark's plain reference
(``port_bench/reference/single_view.py``, which imports nothing of the
port): ``sampling.sample_target_sv`` and the view that
``engine.optimization_iteration_sv`` hands it, on seeded draws over a cache
of the benchmark's ray-cast room, on the CPU; the card comparison's tool at
a tiny size; and, on the card, a single-view frame step without a host sync
outside the core it shares with the multi-view step.

Field ids (on the valid slots), validity, pixels and their RGB-D must be
equal. Distances agree within ``DISTANCE_TOL`` metres: the reference takes
a pixel's distance along its ray as depth times |(x, y, 1)| where the port
divides by the normalised ray's z, and the near and far ends from its own
normalised ray, so the two part by float32 roundings of distances under the
room's 8 m (an ulp there is 4.8e-7 m). A depth mask may part only where the
surface lies within that tolerance of the far end.
"""

import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_tracing import DS_CFG, tiny_config

from neural_graph_mapping_tpu_torch.camera import Camera
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, sampling
from port_bench import run, scene, sv_compare
from port_bench.reference import single_view as ref
from port_bench.tests.tiny import tiny_cell

DISTANCE_TOL = 1e-5  # metres; see the module
W, H, F, R, SLOTS = 40, 30, 4, 16, 6
SCENE = {"width": W, "height": H, "fx": 35.0, "fy": 35.0, "lap_frames": 40, "orbit_radius": 2.5, "room_half": 3.0,
         "keyframe_every": 5}


@pytest.fixture(scope="module")
def cache():
    """Six cached views of the room (slot 0 the current frame), bf16 colour
    as the map keeps it, with a band of pixels that have no depth."""
    lap = [0, 3, 9, 14, 22, 31]
    frames, poses = scene.cast_lap(SCENE, "cpu", lap)
    rgbd = torch.from_numpy(np.stack([frames[i] for i in lap]))
    rgbd[:, 10:13, :, 3] = 0.0
    return (rgbd[..., :3].to(torch.bfloat16), rgbd[..., 3].contiguous(), torch.from_numpy(poses[lap]),
            Camera.create(width=W, height=H, fx=35.0, fy=35.0, cx=W / 2.0, cy=H / 2.0))


class _Stop(Exception):
    pass


def _view_the_port_samples(monkeypatch, cache, cache_valid, positions, active, slot_gumbel, iteration):
    """The view and pose ``optimization_iteration_sv`` hands its sampler
    (the iteration stops there)."""
    cache_rgb, cache_depth, cache_c2w, cam = cache
    seen = {}

    def spy(camera, rgbd_image, c2w, *args, **kwargs):
        seen.update(rgbd=rgbd_image, c2w=c2w)
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(sampling, "sample_target_sv", spy)
        with pytest.raises(_Stop):
            engine.optimization_iteration_sv(
                types.SimpleNamespace(field_radius=1.0), cam, None, None, types.SimpleNamespace(num_rays_per_field=R),
                F, iteration, None, None, None, positions, None, active, cache_rgb, cache_depth, cache_c2w,
                cache_valid, draws=engine.IterationDraws(slot_gumbel=slot_gumbel),
            )
    return seen["rgbd"], seen["c2w"]


CASES = {
    # id: (seed, capacity, cloud points, cloud chunk, active fields (None: all), current frame cached)
    "seed0-cap16": (0, 16, 3_000, 8192, None, True),
    "seed1-cap64": (1, 64, 3_000, 8192, None, True),
    "seed2-cap64-cloud5000-chunk1024": (2, 64, 5_000, 1024, None, True),
    "fewer-eligible-than-slots": (3, 32, 3_000, 8192, 2, True),
    "none-eligible": (4, 32, 3_000, 8192, 0, True),
    "no-current-frame": (5, 32, 2_500, 1024, None, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_and_view_match_the_plain_reference(monkeypatch, cache, case):
    seed, cap, points, chunk, n_active, current = CASES[case]
    cache_rgb, cache_depth, cache_c2w, cam = cache
    g = torch.Generator().manual_seed(seed)
    positions = (torch.rand((cap, 3), generator=g) * 2.0 - 1.0) * 2.5
    active = torch.rand(cap, generator=g) < 0.8
    if n_active is not None:
        active[:] = False
        active[:n_active] = True
    cache_valid = torch.tensor([current] + [True] * (SLOTS - 2) + [False])
    eligible_seen = []
    for iteration in (0, 1, 2, 3):
        slot_gumbel = sampling.gumbel_noise((SLOTS,), g, "cpu")
        cloud_idx = torch.randint(0, H * W, (points,), generator=g)
        u_fields, u_rays = torch.rand(cap, generator=g), torch.rand((F, R), generator=g)
        got_view, got_c2w = _view_the_port_samples(monkeypatch, cache, cache_valid, positions, active, slot_gumbel,
                                                   iteration)
        slot = ref.choose_view(cache_valid, slot_gumbel, iteration)
        if iteration % 2 and current:
            assert slot == 0
        else:
            assert 1 <= slot < SLOTS - 1  # a cached keyframe
        view, view_c2w = ref.view_of(cache_rgb, cache_depth, cache_c2w, slot)
        assert torch.equal(got_view, view) and torch.equal(got_c2w, view_c2w)

        got = sampling.sample_target_sv(cam, view, view_c2w, positions, active, 1.0, F, R, num_cloud_points=points,
                                        cloud_chunk=chunk, cloud_idx=cloud_idx, u_fields=u_fields, u_rays=u_rays)
        want = ref.draw_targets(view, view_c2w, positions, active, 1.0, F, R, ref.Pinhole(35.0, 35.0, W / 2.0, H / 2.0),
                                cloud_idx, u_fields, u_rays)
        v = want.field_valid
        assert torch.equal(got.field_valid, v)
        assert torch.equal(got.field_ids[v], want.field_ids[v])
        assert torch.equal(got.ijs, want.ijs) and torch.equal(got.rgbds, want.rgbds)
        for a, b in ((got.near_distances, want.near), (got.far_distances, want.far),
                     (got.gt_distances, want.gt_distances)):
            gap = (a - b)[v].abs()
            assert gap.numel() == 0 or float(gap.max()) <= DISTANCE_TOL
        clear = (want.gt_distances - want.far).abs() > DISTANCE_TOL
        assert torch.equal(got.depth_mask & clear, want.depth_mask & clear)
        assert torch.equal(got.term_mask, want.term_mask)
        eligible_seen.append(int(want.eligible.sum()))
    if n_active == 0:
        assert eligible_seen == [0] * 4
    elif n_active is not None:
        assert max(eligible_seen) <= n_active < F
    else:
        assert min(eligible_seen) > F  # the draw chooses among more fields than it trains


def test_the_plain_reference_imports_nothing_of_the_port_its_copy_or_jax():
    """Imported alone, the reference loads no module of the port, of its
    frozen copy (``port_bench.reference.ngm``) or of JAX."""
    code = ("import sys, port_bench.reference.single_view\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
            "             or m.startswith(('neural_graph_mapping', 'port_bench.reference.ngm'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(pathlib.Path(ref.__file__).resolve().parents[2]))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_card_comparison_at_a_tiny_size(monkeypatch, tmp_path):
    """``port_bench.sv_compare`` on the CPU: the tiny cell's set-up, then two
    window frames whose every iteration equals the reference's draw."""
    monkeypatch.setattr(run, "CACHE", tmp_path)
    cfg, wl = tiny_cell("sv_replay")
    out = sv_compare.compare_run(cfg, wl, 2**31 + 11, 2, "cpu")
    iters = cfg["map"]["num_iterations_per_frame"]
    assert len(out["iterations"]) == 2 * iters and out["map"]["fields"] > 0
    assert all(sv_compare.passed(r) for r in out["iterations"]), out["iterations"]
    assert [r["iteration"] for r in out["iterations"]] == list(range(iters)) * 2


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_single_view_frame_step_makes_no_host_sync_outside_the_shared_core(cuda):
    """A warm single-view frame's device program (cache write, active-field
    mask, view choice, sampler) under sync debug mode "error": a host sync
    raises. The core it shares with the multi-view step (render, losses,
    backward, Adam) runs outside that mode."""
    from neural_graph_mapping_tpu_torch.ops import cuda_build

    cuda_build.load_all()
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(tiny_config(update_mode="single_view"), "cuda")
    for f in range(2):
        ngm.process_frame(ds, f, ds[f]["rgbd"])
    real = ngm._frame_step

    def strict(*args, **kwargs):
        with sv_compare.strict_outside_core(engine):
            return real(*args, **kwargs)

    ngm._frame_step = strict
    losses = ngm.process_frame(ds, 2, ds[2]["rgbd"])
    assert losses and all(np.isfinite(v) for v in losses.values())



@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_graphed_single_view_sampler_matches_the_plain_reference(monkeypatch, device):
    """The sampler as the frame step replays it from its pre graph
    (``mapping/frame_graphs.py``), held against the reference as
    ``sv_compare`` holds the eager sampler: after each replayed iteration,
    the graph's targets against the reference's draw on the same cache,
    map, active mask and draws (a DrawSource's). A graph hands out no view,
    so the view is the reference's own choice; a wrong one shows in the
    pixels' RGB-D. On the CPU the graphs are the eager stand-in of
    ``test_torch_frame_graphs``."""
    from test_torch_frame_graphs import _EagerRecord, _map

    from neural_graph_mapping_tpu_torch.mapping import frame_graphs
    from port_bench import traffic

    cfg = tiny_config(update_mode="single_view")
    if device == "cpu":
        monkeypatch.setattr(frame_graphs.FrameGraphs, "_record", lambda self, fn, warm=True, draws=False: _EagerRecord(fn))
        ngm = _map(cfg, True, True)
    else:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        from neural_graph_mapping_tpu_torch.ops import cuda_build

        cuda_build.load_all()
        ngm = engine.NeuralGraphMap(cfg, "cuda", draws=traffic.SeededDraws(13, cfg, "cuda"))
    assert ngm._graphs is not None
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    records = []
    real = frame_graphs.FrameGraphs.iteration

    def held(self, camera, maps, targets, inputs, draws, eager):
        self._bind(camera, maps)  # a new key drops the graphs before the iteration
        replayed = self._segments is not None or self._iter_warm
        it = {"iter_idx": int(inputs["odd"]), "draws": draws, "map_positions": maps[3].clone(),
              "active_mask": inputs["mask"].clone(),
              **dict(zip(("cache_rgb", "cache_depth", "cache_c2w", "cache_valid"), [t.clone() for t in maps[5]]))}
        out = real(self, camera, maps, targets, inputs, draws, eager)
        if replayed:
            slot = ref.choose_view(it["cache_valid"], draws.slot_gumbel, it["iter_idx"])
            view, view_c2w = ref.view_of(it["cache_rgb"], it["cache_depth"], it["cache_c2w"], slot)
            call = {"camera": camera, "field_radius": self._fset.field_radius,
                    "num_train_fields": cfg["num_train_fields"],
                    "num_rays_per_field": self._loss_cfg.num_rays_per_field,
                    "cloud_idx": draws.cloud_idx, "u_fields": draws.u_fields, "u_rays": draws.u_rays,
                    "rgbd_image": view, "c2w": view_c2w}
            records.append(sv_compare.held_against_reference(it, call, self._segments.pre.outputs.target))
        return out

    monkeypatch.setattr(frame_graphs.FrameGraphs, "iteration", held)
    for f in range(DS_CFG["num_frames"]):
        ngm.process_frame(ds, f, torch.as_tensor(ds[f]["rgbd"]).to(ngm._device))
    assert len(records) >= 10 and any(r["slots_valid"] for r in records)
    assert all(sv_compare.passed(r) for r in records), [r for r in records if not sv_compare.passed(r)]
