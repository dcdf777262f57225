"""The port's CLI runner against the JAX package's on the CPU.

- ``split_sequence`` gives JAX's train, eval and chunk sets.
- ``main([..., "--device", "cpu"])`` on the on-disk NRGBD scenes of
  tests/test_cli_e2e.py and tests/test_eval_e2e.py (the latter with its quad
  ground-truth mesh, held-out frames, LPIPS from synthetic weights and mesh
  evaluation): the npz keys and shapes and the final metric keys equal a
  JAX run of the same config, and ``latest_run.yaml`` points at the
  checkpoint.
- Checkpoints both ways: a JAX checkpoint renders in the port exactly as
  its params carried across with ``interop`` do; a port checkpoint loads in
  JAX's ``load_model`` with every ``params.*`` / ``map.*`` array equal; a
  level-major table is refused.
- Full resume: 6 frames, save, load into a fresh runner, 3 more frames
  equal 9 uninterrupted frames bit for bit (parameters, Adam state, map
  arrays, frame counter, generators).
"""

import json
import types

import numpy as np
import pytest
import torch
import yaml

from test_torch_engine import DS_CFG, tiny_config
from test_torch_mesh_eval import (
    CLI_H, CLI_W, eval_dataset_config, write_cli_scene, write_eval_scene, write_lpips_weights,
)

from neural_graph_mapping_tpu import run_mapping as jrun
from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.eval import render_metrics as jrender_metrics
from neural_graph_mapping_tpu_torch import interop, run_mapping
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.eval import render_metrics
from neural_graph_mapping_tpu_torch.mapping import engine

NRGBD = "neural_graph_mapping_tpu.datasets.nrgbd.NRGBDDataset"
SYNTHETIC = "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset"


def _split(runner_cls, dataset, ratio, chunk_freq):
    ns = types.SimpleNamespace(_eval_ratio=ratio, _eval_chunk_freq=chunk_freq)
    runner_cls.split_sequence(ns, dataset)
    return ns.train_frame_ids, ns.eval_frame_ids, ns.chunks


@pytest.mark.parametrize("ratio,chunk_freq", [(0.1, 5), (0.25, 2), (0.5, None), (0.0, 5)])
def test_split_sequence_synthetic_equals_jax(ratio, chunk_freq):
    cfg = {"num_frames": 60, "width": 16, "height": 12, "fx": 14.0, "fy": 14.0}
    ds, jds = SyntheticDataset(cfg), JaxSynthetic(cfg)
    ds.load_slam_results()
    jds.load_slam_results()
    got = _split(run_mapping.NeuralGraphMapRunner, ds, ratio, chunk_freq)
    want = _split(jrun.NeuralGraphMapRunner, jds, ratio, chunk_freq)
    assert got == want
    if ratio:
        assert got[1] and len(got[2]) >= (2 if chunk_freq else 1)


def test_split_sequence_nrgbd_equals_jax(tmp_path):
    cfg = eval_dataset_config(write_eval_scene(tmp_path))
    ds, jds = NRGBDDataset(cfg), JaxNRGBD(cfg)
    ds.load_slam_results()
    jds.load_slam_results()
    for ratio, freq in [(0.5, None), (0.5, 2), (1.0, 1)]:
        assert _split(run_mapping.NeuralGraphMapRunner, ds, ratio, freq) == _split(
            jrun.NeuralGraphMapRunner, jds, ratio, freq
        )


# -- the CLI, end to end ------------------------------------------------------------


def _nrgbd_config(dataset_config, **extra):
    cfg = dict(tiny_config())
    cfg.update(
        {
            "model_type": "neural_graph_mapping_tpu.models.fields.NeuralFieldSet",
            "dataset_type": NRGBD,
            "dataset_config": dataset_config,
            "num_iterations_per_frame": 1,
            # short renders and mesh chunks: both packages pad a chunk to this
            "eval_num_samples": 64,
            "block_size": 16384,
        }
    )
    cfg.update(extra)
    return cfg


def _run_both(tmp_path, cfg):
    """main() of both packages on one YAML file -> {package: run dir}."""
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    jrun.main(["--config", str(path), "--out_dir", str(tmp_path / "jax")])
    run_mapping.main(["--config", str(path), "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    dirs = {}
    for name in ("jax", "port"):
        runs = list((tmp_path / name).iterdir())
        assert len(runs) == 1
        dirs[name] = runs[0]
    return dirs


def _checkpoint(run_dir):
    ckpts = list(run_dir.glob("*.npz"))
    assert len(ckpts) == 1
    return ckpts[0]


def _shapes(path):
    with np.load(path) as data:
        return {k: data[k].shape for k in data.files}


JAX_ONLY = {"resume.rng_key", "resume.base_key"}
PORT_ONLY = {"resume.frame_counter", "resume.init_gen_state", "resume.frame_gen_state"}


def _assert_same_run_outputs(dirs, full):
    got, want = _shapes(_checkpoint(dirs["port"])), _shapes(_checkpoint(dirs["jax"]))
    if full:
        assert JAX_ONLY <= set(want) and PORT_ONLY <= set(got)
        want = {k: v for k, v in want.items() if k not in JAX_ONLY}
        got = {k: v for k, v in got.items() if k not in PORT_ONLY}
    assert set(got) == set(want)
    for k in want:
        if k != "resume.state_json":  # JSON text of host bookkeeping
            assert got[k] == want[k], k
    for name in ("port", "jax"):
        rerun = yaml.safe_load((dirs[name] / "latest_run.yaml").read_text())
        assert rerun["model"] == str(_checkpoint(dirs[name]))
    got_m = yaml.safe_load((dirs["port"] / "latest_run.yaml").read_text())["results"]
    want_m = yaml.safe_load((dirs["jax"] / "latest_run.yaml").read_text())["results"]
    assert set(got_m) == set(want_m)
    assert got_m["num_params_per_field"] == want_m["num_params_per_field"]
    assert all(np.isfinite(v) for v in got_m.values())
    return got_m


def test_cli_nrgbd_fixture_matches_jax(tmp_path):
    """tests/test_cli_e2e.py's run: no eval, no mesh, plain checkpoint."""
    ds_cfg = {
        "root_dir": str(write_cli_scene(tmp_path / "scene")), "scene": "tinyroom",
        "camera": {"width": CLI_W, "height": CLI_H, "fx": 28.0, "fy": 28.0, "cx": 16.0, "cy": 12.0},
        "pose_source": "gt", "pg_source": "fixed_kf_freq", "fixed_kf_freq": 2,
    }
    dirs = _run_both(tmp_path, _nrgbd_config(ds_cfg, disable_eval=True, extract_mesh=False))
    metrics = _assert_same_run_outputs(dirs, full=False)
    assert metrics["num_fields"] > 0
    for k in ("fps_estimate", "spf_estimate", "wall_fps", "phase_graph_s", "phase_alloc_s",
              "phase_host_misc_s", "phase_data_wait_s", "phase_h2d_s"):
        assert metrics[k] > 0, k


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Both packages' CLI on tests/test_eval_e2e.py's scene with the full
    protocol (held-out chunk eval, LPIPS, mesh extraction and evaluation,
    a full checkpoint), rendered at half resolution to keep it short."""
    tmp = tmp_path_factory.mktemp("eval_runs")
    data_root = write_eval_scene(tmp / "scene")
    weights = write_lpips_weights(tmp / "lpips.npz")
    mp = pytest.MonkeyPatch()
    mp.setenv("NGM_LPIPS_WEIGHTS", str(weights))
    for mod in (render_metrics, jrender_metrics):
        mod._lpips_weights.cache_clear()
    cfg = _nrgbd_config(
        eval_dataset_config(data_root),
        eval_ratio=0.5, eval_metrics=["psnr", "ssim", "depthl1", "lpips"], eval_render_scale=0.5,
        eval_mesh=True, eval_mesh_num_points=2000, extract_mesh=True, mesh_resolution=0.3,
        extract_mesh_fields=[0], checkpoint_full=True, host_prefetch_depth=2,
    )
    try:
        dirs = _run_both(tmp, cfg)
    finally:
        mp.undo()
        for mod in (render_metrics, jrender_metrics):
            mod._lpips_weights.cache_clear()
    return cfg, dirs


def test_cli_full_eval_protocol_matches_jax(eval_runs):
    cfg, dirs = eval_runs
    metrics = _assert_same_run_outputs(dirs, full=True)
    for m in cfg["eval_metrics"]:
        assert f"online_{m}" in metrics and f"final_{m}" in metrics
    for k in ("mesh_accuracy", "mesh_completion", "mesh_f1_5cm", "fps_estimate", "wall_fps"):
        assert k in metrics
    eval_dir = dirs["port"] / "eval_data"
    details = (eval_dir / "details.txt").read_text().splitlines()
    assert all(m in details[0] for m in cfg["eval_metrics"])
    assert len([row for row in details[2:] if row.strip()]) == 4
    assert list(eval_dir.glob("*final.ply")) and list(eval_dir.glob("*final_0.ply"))
    assert {p.name for p in eval_dir.iterdir()} == {p.name for p in (dirs["jax"] / "eval_data").iterdir()}


def _runner(cfg, out_dir, device="cpu"):
    return run_mapping.NeuralGraphMapRunner(dict(cfg, out_dir=str(out_dir)), device=device)


def test_jax_checkpoint_renders_in_port_as_carried_params(eval_runs, tmp_path):
    cfg, dirs = eval_runs
    path = _checkpoint(dirs["jax"])
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    ds = NRGBDDataset(cfg["dataset_config"])
    cam = ds.camera.scaled_camera(0.5)
    c2w = ds.gt_c2ws[3]

    loaded = _runner(cfg, tmp_path / "a")
    loaded.load_model(path)
    carried = _runner(cfg, tmp_path / "b").engine
    carried._params = interop.params_from_jax(
        {k[len("params."):]: v for k, v in data.items() if k.startswith("params.")}, "cpu"
    )
    carried._map_arrays = interop.map_arrays_from_jax(
        data["map.positions"], data["map.orientations"], data["map.kf_ids"], data["map.kf_slots"],
        data["map.training_iterations"], "cpu",
    )
    carried._num_fields = int(data["num_fields"])
    assert loaded.engine.num_fields == carried.num_fields > 0
    got = loaded.engine.render_image(c2w, cam)[0]
    want = carried.render_image(c2w, cam)[0]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a JAX full checkpoint restores all but the generators
    assert loaded.engine.throughput.frames == json.loads(bytes(data["resume.state_json"]).decode())[
        "frames_processed"]
    np.testing.assert_array_equal(loaded.engine._adam.steps.numpy(), data["resume.adam_steps"])
    assert loaded.engine._frame_counter == 0


def test_score_checkpoint_renders_a_jax_runs_held_out_frames(eval_runs, tmp_path):
    """scripts/score_checkpoint on the JAX run's checkpoint: JAX's held-out
    frames, the checkpoint's fields, and the port's PSNR / depth-L1 of them
    at the last frame's pose estimate, equal to rendering them from a
    runner that loaded the same file."""
    from neural_graph_mapping_tpu_torch.scripts import score_checkpoint

    cfg, dirs = eval_runs
    cfg = dict(cfg, eval_metrics=["psnr", "depthl1"], out_dir=str(tmp_path / "score"))
    path = _checkpoint(dirs["jax"])
    got = score_checkpoint.score(cfg, str(path), "cpu")
    jds = JaxNRGBD(cfg["dataset_config"])
    jds.load_slam_results()
    _, want_eval, _ = _split(jrun.NeuralGraphMapRunner, jds, cfg["eval_ratio"], cfg.get("eval_chunk_freq"))
    assert got["eval_frames"] == sorted(want_eval) and want_eval
    with np.load(path) as npz:
        assert got["num_fields"] == int(npz["num_fields"]) > 0
    runner = _runner(dict(cfg, eval_store_details=False), tmp_path / "direct")
    runner.dataset = NRGBDDataset(cfg["dataset_config"])
    runner.dataset.load_slam_results()
    runner.load_model(path)
    last = len(runner.dataset) - 1
    direct = run_mapping.mean_metric_dicts([runner.evaluate_frame(f, last) for f in got["eval_frames"]])
    assert got["final_psnr"] == direct["psnr"] and got["final_depthl1"] == direct["depthl1"]
    assert np.isfinite(got["final_psnr"])


def test_port_checkpoint_loads_in_jax(eval_runs, tmp_path):
    cfg, dirs = eval_runs
    path = _checkpoint(dirs["port"])
    jrunner = jrun.NeuralGraphMapRunner(
        dict(cfg, out_dir=str(tmp_path), dataset_type="neural_graph_mapping_tpu.datasets.nrgbd.NRGBDDataset")
    )
    jrunner.load_model(path)
    e = jrunner.engine
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("params."):
                np.testing.assert_array_equal(np.asarray(e._params[k[len("params."):]]), data[k], err_msg=k)
            elif k.startswith("map."):
                np.testing.assert_array_equal(np.asarray(getattr(e._map_arrays, k[4:])), data[k], err_msg=k)
        assert e.num_fields == int(data["num_fields"]) > 0
        np.testing.assert_array_equal(np.asarray(e._adam.steps), data["resume.adam_steps"])


def test_level_major_table_is_refused(eval_runs, tmp_path):
    cfg, dirs = eval_runs
    with np.load(_checkpoint(dirs["port"])) as npz:
        data = {k: npz[k] for k in npz.files}
    t = data["params.enc.table"]  # (N, F, L, T)
    assert t.shape[1] != t.shape[2]
    data["params.enc.table"] = np.swapaxes(t, 1, 2)
    bad = tmp_path / "old_layout.npz"
    np.savez(bad, **data)
    with pytest.raises(ValueError, match="layout-flip"):
        _runner(cfg, tmp_path).load_model(bad)


def test_cli_needs_the_model_config(tmp_path):
    with pytest.raises(ValueError, match="neural_graph_map.yaml"):
        run_mapping.main(["--config", "synthetic.yaml", "--device", "cpu", "--out_dir", str(tmp_path)])


def test_cli_synthetic_config_on_cpu(tmp_path):
    """The shipped configs (config/neural_graph_map.yaml then
    config/synthetic.yaml) through the port's CLI on the CPU, the scene cut
    to 12 frames at 40x30, 64 rays a field, one iteration a frame, 32
    samples a ray in held-out renders."""
    run_mapping.main([
        "--config", "neural_graph_map.yaml", "synthetic.yaml", "--device", "cpu",
        "--out_dir", str(tmp_path), "--dataset_config.num_frames", "12",
        "--dataset_config.width", "40", "--dataset_config.height", "30",
        "--dataset_config.fx", "35.0", "--dataset_config.fy", "35.0",
        "--num_iterations_per_frame", "1", "--num_rays_per_field", "64", "--eval_ratio", "0.34",
        "--eval_span_samples", "32", "--mesh_resolution", "0.4", "--block_size", "16384",
        "--eval_store_details", "false",
    ])
    run_dir = next(tmp_path.iterdir())
    metrics = yaml.safe_load((run_dir / "latest_run.yaml").read_text())["results"]
    for k in ("online_psnr", "final_psnr", "final_depthl1", "fps_estimate", "num_fields"):
        assert np.isfinite(metrics[k]), k
    assert list((run_dir / "eval_data").glob("*final.ply"))


# -- full resume ---------------------------------------------------------------------


def _resume_config(out_dir):
    cfg = dict(tiny_config())
    cfg.update({"dataset_type": SYNTHETIC, "dataset_config": DS_CFG, "disable_eval": True,
                "extract_mesh": False, "out_dir": str(out_dir), "num_iterations_per_frame": 2})
    return cfg


def _frames(runner, ds, frame_ids):
    runner.dataset = ds
    for fid in frame_ids:
        runner.engine.process_frame(ds, fid, torch.from_numpy(ds[fid]["rgbd"]))


def _state(e):
    out = {f"params.{k}": v for k, v in e._params.items()}
    out.update({f"adam_m.{k}": v for k, v in e._adam.m.items()})
    out.update({f"adam_v.{k}": v for k, v in e._adam.v.items()})
    out["adam_steps"] = e._adam.steps
    out.update({f"map.{k}": getattr(e._map_arrays, k) for k in e._map_arrays._fields})
    out["cache_rgb"] = e._cache_rgb.float()
    out["cache_depth"] = e._cache_depth
    out["init_gen"] = e._init_gen.get_state()
    out["frame_gen"] = e._frame_gen.get_state()
    return out


def test_full_resume_equals_uninterrupted_run(tmp_path):
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    straight = _runner(_resume_config(tmp_path / "a"), tmp_path / "a")
    _frames(straight, ds, range(9))

    first = _runner(_resume_config(tmp_path / "b"), tmp_path / "b")
    _frames(first, ds, range(6))
    path = first.save_model(tmp_path / "ckpt.npz", full=True)
    resumed = _runner(_resume_config(tmp_path / "c"), tmp_path / "c")
    resumed.load_model(path)
    assert resumed.engine._frame_counter == 6
    _frames(resumed, ds, range(6, 9))

    a, b = straight.engine, resumed.engine
    assert a.num_fields == b.num_fields > 0 and b._frame_counter == a._frame_counter == 9
    assert b._graph == a._graph and b._kf2fields == a._kf2fields and b._free_slots == a._free_slots
    assert b.throughput.frames == a.throughput.frames == 9
    want, got = _state(a), _state(b)
    assert set(got) == set(want)
    for k in want:  # bit for bit
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_process_frame_takes_a_device_frame_without_a_copy(monkeypatch):
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
    seen = []
    orig = engine.frame_step

    def spy(*args, **kwargs):
        seen.append(args[19])  # rgbd
        return orig(*args, **kwargs)

    monkeypatch.setattr(engine, "frame_step", spy)
    frame = torch.from_numpy(ds[0]["rgbd"])
    ngm.process_frame(ds, 0, frame)
    assert seen[0].data_ptr() == frame.data_ptr()
