"""Field-axis sharding of the port (``parallel/sharding.py``) on the CPU, with
``torch.distributed`` over ``gloo``: ranks are spawned processes that meet
through a ``file://`` rendezvous in the test's temporary directory (no
ports), one thread each.

- ``render_points_sharded`` at W = 2 and 4 against JAX's on its 8-device
  mesh and JAX's unsharded ``apply_knn_tiled`` (interpret mode), same
  params: JAX's own tolerance, atol 2e-5 / rtol 1e-4.
- One sharded iteration at W = 2 on JAX's draws against JAX's
  ``optimization_iteration`` with the params and Adam state sharded over 8
  devices (``num_field_shards: 8``): losses as ``test_one_iteration_matches_
  jax`` holds them (atol 1e-7, rtol 1e-4), training counts exact, and the
  gradient, read back from Adam's first moment, and the stepped params
  within its 1e-5.
- The sharded engine (W = 2, 4; multi- and single-view; the capacity
  doubles inside the run) against the unsharded engine on the same seeds
  over ``tests/test_multichip.py``'s 6-frame scene: losses rel <= 1e-5,
  the gathered params and a render within 1e-6.
- Checkpoints: a W = 2 checkpoint has the unsharded keys and layout, loads
  at W = 1 (renders as the sharded map did) and in JAX's ``load_model``;
  a full resume at W = 2 equals the uninterrupted run bit for bit.
- ``torchrun --nproc_per_node 2`` of the CLI on the CPU writes the npz of a
  W = 1 run: the same keys, shapes and values.

The module imports no JAX at its top: the spawned ranks import it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
SYNTHETIC = "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset"
DS_CFG = {"num_frames": FRAMES, "width": 40, "height": 30, "fx": 35.0, "fy": 35.0}
RESUME_DS_CFG = dict(DS_CFG, num_frames=9)


def field_kwargs(log2_hashmap_size=6):
    return {
        "encoding_type": "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
        "encoding_kwargs": {
            "pos_dim": 3, "log2_hashmap_size": log2_hashmap_size, "nr_levels": 4, "nr_feat_per_level": 2,
            "coarsest_scale": 1.0, "finest_scale": 0.01, "init_scale": 1e-5,
        },
        "num_layers": 1, "dim_out": 4,
    }


def fieldset_kwargs():
    """tests/test_multichip.py's field set."""
    return dict(
        dim_points=3, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=field_kwargs(), num_knn=2, distance_factor=10.0, outside_value=1.0,
        field_radius=1.0, scale_mode="unit_cube",
    )


def engine_config(w, update_mode="multi_view"):
    """tests/test_multichip.py's engine config, with short held-out spans."""
    return {
        "model_kwargs": fieldset_kwargs(),
        "field_radius": 1.0, "num_train_fields": 8, "num_rays_per_field": 32,
        "num_samples_coarse": 4, "num_samples_depth_guided": 4, "num_iterations_per_frame": 2,
        "num_kf_slots": 32, "max_new_fields": 64, "num_field_shards": w, "seed": 3,
        "update_mode": update_mode, "eval_span_samples": 16,
    }


def runner_config(w, out_dir, ds_cfg=DS_CFG):
    return dict(engine_config(w), dataset_type=SYNTHETIC, dataset_config=ds_cfg, disable_eval=True,
                extract_mesh=False, out_dir=str(out_dir))


def _dataset(cfg=DS_CFG):
    from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg)
    ds.load_slam_results()
    return ds


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def run_engine(w, update_mode, group=None, frames=FRAMES):
    """The map over the 6-frame scene -> (losses, full params, capacity,
    fields, a 10x7 render of the last pose)."""
    from neural_graph_mapping_tpu_torch.mapping.engine import NeuralGraphMap

    ds = _dataset()
    ngm = NeuralGraphMap(engine_config(w, update_mode), "cpu", group=group)
    losses = [ngm.process_frame(ds, f, ds[f]["rgbd"]) for f in range(frames)]
    params = _np(ngm.full_params())
    img, _ = ngm.render_image(ds.get_slam_c2ws(frames - 1), ds.camera.scaled_camera(0.25))
    return dict(losses=losses, params=params, capacity=ngm.capacity, fields=ngm.num_fields, render=img.numpy())


def _train(runner, ds, frame_ids):
    runner.dataset = ds
    for fid in frame_ids:
        runner.engine.process_frame(ds, fid, torch.from_numpy(ds[fid]["rgbd"]))


def _full_state(e):
    adam = e.full_adam()
    out = {f"params.{k}": v for k, v in e.full_params().items()}
    out.update({f"adam_m.{k}": v for k, v in adam.m.items()})
    out.update({f"adam_v.{k}": v for k, v in adam.v.items()})
    out["adam_steps"] = adam.steps
    out.update({f"map.{k}": getattr(e._map_arrays, k) for k in e._map_arrays._fields})
    out["init_gen"] = e._init_gen.get_state()
    out["frame_gen"] = e._frame_gen.get_state()
    return out


def checkpoint_and_resume(w, tmp, group):
    """A W-rank runner saves a full checkpoint after 6 frames (and renders);
    a fresh runner resumes from it for 3 frames -> max |difference| of
    every state leaf against 9 uninterrupted frames, and the render."""
    from neural_graph_mapping_tpu_torch import run_mapping

    ds = _dataset(RESUME_DS_CFG)
    straight = run_mapping.NeuralGraphMapRunner(runner_config(w, tmp / "a", RESUME_DS_CFG), "cpu", group)
    _train(straight, ds, range(9))
    first = run_mapping.NeuralGraphMapRunner(runner_config(w, tmp / "b", RESUME_DS_CFG), "cpu", group)
    _train(first, ds, range(6))
    first.save_model(tmp / f"ckpt_w{w}.npz", full=True)
    img, _ = first.engine.render_image(ds.get_slam_c2ws(5), ds.camera.scaled_camera(0.25))
    resumed = run_mapping.NeuralGraphMapRunner(runner_config(w, tmp / "c", RESUME_DS_CFG), "cpu", group)
    resumed.load_model(tmp / f"ckpt_w{w}.npz")
    _train(resumed, ds, range(6, 9))
    want, got = _full_state(straight.engine), _full_state(resumed.engine)
    diffs = {k: float((got[k].double() - want[k].double()).abs().max()) for k in want}
    return dict(resume_diffs=diffs, checkpoint_render=img.numpy())


def sharded_iteration(inputs, group):
    """One multi-view iteration of the sharded map state on replayed draws
    -> (losses, full params, full Adam m, training counts)."""
    from neural_graph_mapping_tpu_torch.mapping import engine, optimizer
    from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
    from neural_graph_mapping_tpu_torch.parallel import sharding

    it = inputs["iteration"]
    fset = NeuralFieldSet(**it["fieldset"])
    params = sharding.shard_field_tensors(it["params"], group)
    adam = optimizer.init_adam_state(params)
    ti = it["training_iterations"].clone()
    _, adam, ti, losses = engine.optimization_iteration(
        fset, it["camera"], it["rcfg"], it["ocfg"], it["lcfg"], it["num_train_fields"], params, adam, ti,
        *it["maps"], *it["cache"], draws=it["draws"], shard=group,
    )
    m = sharding.gather_field_tensors(adam.m, group)
    return dict(losses={k: float(v) for k, v in losses.items()}, params=_np(sharding.gather_field_tensors(params, group)),
                adam_m=_np(m), training_iterations=ti.numpy())


def rank_main(rank, w, tmp):
    """One rank: every scenario of this module at W ranks; rank 0 saves."""
    import pathlib

    from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
    from neural_graph_mapping_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    group = sharding.make_field_group(w, "gloo", init_method=f"file://{tmp}/pg_w{w}", rank=rank, device="cpu")
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {}
    r = inputs["render"]
    out["render_points"] = sharding.render_points_sharded(
        NeuralFieldSet(**fieldset_kwargs()), sharding.shard_field_tensors(r["params"], group), r["positions"],
        r["orientations"], r["valid"], r["points"], group,
    ).numpy()
    for mode in ("multi_view", "single_view"):
        out[mode] = run_engine(w, mode, group)
    if w == 2:
        out["iteration"] = sharded_iteration(inputs, group)
        out.update(checkpoint_and_resume(w, tmp, group))
    if rank == 0:
        torch.save(out, tmp / f"out_w{w}.pt")
    torch.distributed.destroy_process_group()


def _render_inputs():
    """JAX-initialised params of 16 fields (3 invalid) and seeded centres,
    orientations and 300 query points, as tests/test_multichip.py's render
    test has them -> (JAX field set, numpy inputs)."""
    import jax

    from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet

    fset = JaxFieldSet(**fieldset_kwargs())
    n = 16
    rng = np.random.default_rng(0)
    orientations = rng.normal(size=(n, 4)).astype(np.float32)
    return fset, dict(
        params={k: np.asarray(v) for k, v in fset.init_fields(jax.random.PRNGKey(0), n).items()},
        positions=(rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
        orientations=orientations / np.linalg.norm(orientations, axis=-1, keepdims=True),
        valid=np.arange(n) < 13,
        points=(rng.normal(size=(300, 3)) * 2.5).astype(np.float32),
    )


def _iteration_inputs():
    """An unsharded port map after 3 frames and JAX's draws of one
    iteration replayed for the port -> (port inputs, a function running
    JAX's iteration on that state with the params and Adam state sharded
    over 8 devices)."""
    import jax
    import jax.numpy as jnp

    from test_torch_engine import _replayed_draws

    from neural_graph_mapping_tpu_torch.mapping.engine import NeuralGraphMap

    ds = _dataset()
    ngm = NeuralGraphMap(engine_config(1), "cpu")
    for f in range(3):
        ngm.process_frame(ds, f, ds[f]["rgbd"])
    cap = ngm.capacity
    assert cap % 8 == 0 and ngm.num_fields > 8
    f, r, s = ngm._num_train_fields, ngm._loss_cfg.num_rays_per_field, ngm._num_kf_slots
    maps = (ngm._map_arrays.positions, ngm._map_arrays.orientations, ngm._allocated_mask(), ngm._observed_mask)
    cache = (ngm._cache_rgb, ngm._cache_depth, ngm._cache_c2w_dev, ngm._cache_valid_dev)
    params = {k: v.clone() for k, v in ngm._params.items()}
    rc, oc, lc = ngm._rcfg, ngm._ocfg, ngm._loss_cfg
    key = jax.random.PRNGKey(7)
    draws = _replayed_draws(key, cap, f, r, s, rc.num_samples_coarse, rc.num_samples_depth_guided)
    port = dict(fieldset=fieldset_kwargs(), params=params, training_iterations=torch.zeros((cap,), dtype=torch.int32),
                camera=ds.camera, rcfg=rc, ocfg=oc, lcfg=lc, num_train_fields=f, maps=maps, cache=cache,
                draws=draws)

    def jax_iteration():
        from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
        from neural_graph_mapping_tpu.mapping import engine as jengine
        from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
        from neural_graph_mapping_tpu.mapping import render as jrender
        from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
        from neural_graph_mapping_tpu.parallel import sharding as jshd

        mesh = jshd.make_field_mesh(8)
        jp = jshd.shard_field_pytree({k: jnp.asarray(v.numpy()) for k, v in params.items()}, mesh)
        adam0 = joptimizer.init_adam_state(jp)
        jadam = joptimizer.AdamState(
            m=jshd.shard_field_pytree(adam0.m, mesh), v=jshd.shard_field_pytree(adam0.v, mesh),
            steps=jax.device_put(adam0.steps, jshd.field_sharding(mesh)),
        )
        jmaps = tuple(jnp.asarray(x.numpy()) for x in maps)
        jcache = (jnp.asarray(cache[0].float().numpy(), jnp.bfloat16),) + tuple(
            jnp.asarray(x.numpy()) for x in cache[1:])
        with mesh:
            jparams, jadam, jti, jlosses = jengine.optimization_iteration(
                JaxFieldSet(**fieldset_kwargs()), JaxSynthetic(DS_CFG).camera,
                jrender.RenderConfig(**rc._asdict()), joptimizer.AdamConfig(**oc._asdict()),
                jengine.LossConfig(**lc._asdict()), f, jp, jadam, jnp.zeros((cap,), jnp.int32), *jmaps, *jcache,
                key,
            )
        assert jparams["w0"].sharding.spec[0] == jshd.FIELD_AXIS
        return dict(losses={k: float(v) for k, v in jlosses.items()},
                    params={k: np.asarray(v) for k, v in jparams.items()},
                    adam_m={k: np.asarray(v) for k, v in jadam.m.items()}, training_iterations=np.asarray(jti))

    return port, jax_iteration


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario at W = 2 and 4 in spawned ranks (both groups at once,
    while this process computes the references: JAX's sharded and
    unsharded renders and iteration, the unsharded port)."""
    from neural_graph_mapping_tpu.parallel import sharding as jshd

    tmp = tmp_path_factory.mktemp("sharding")
    fset, render_in = _render_inputs()
    port_iteration, jax_iteration = _iteration_inputs()
    torch.save(dict(render={k: ({n: torch.tensor(a) for n, a in v.items()} if isinstance(v, dict)
                                else torch.tensor(v)) for k, v in render_in.items()},
                    iteration=port_iteration), tmp / "inputs.pt")
    ranks = {w: mp.start_processes(rank_main, args=(w, str(tmp)), nprocs=w, join=False, start_method="spawn")
             for w in (2, 4)}
    args = [render_in[k] for k in ("params", "positions", "orientations", "valid", "points")]
    jax_render = dict(
        sharded=np.asarray(jshd.render_points_sharded(fset, *args, jshd.make_field_mesh(8), interpret=True)),
        unsharded=np.asarray(fset.apply_knn_tiled(*args[:1], args[4], *args[1:4], interpret=True)),
    )
    jax_it = jax_iteration()
    unsharded = {mode: run_engine(1, mode) for mode in ("multi_view", "single_view")}
    out = {}
    for w, ctx in ranks.items():
        while not ctx.join():
            pass
        out[w] = torch.load(tmp / f"out_w{w}.pt", weights_only=False)
    return dict(tmp=tmp, out=out, jax_render=jax_render, jax_iteration=jax_it, unsharded=unsharded)


@pytest.mark.parametrize("w", [2, 4])
def test_render_points_sharded_matches_jax(runs, w):
    got = runs["out"][w]["render_points"]
    for name in ("sharded", "unsharded"):
        np.testing.assert_allclose(got, runs["jax_render"][name], atol=2e-5, rtol=1e-4, err_msg=name)


def test_sharded_iteration_matches_jax_sharded_iteration(runs):
    got, want = runs["out"][2]["iteration"], runs["jax_iteration"]
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, atol=1e-7, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["training_iterations"], want["training_iterations"])
    assert got["training_iterations"].sum() > 0
    # Adam's first moment after one step is (1 - beta1) * gradient
    for k in want["adam_m"]:
        np.testing.assert_allclose(got["adam_m"][k] / 0.1, want["adam_m"][k] / 0.1, atol=1e-5, err_msg=k)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["multi_view", "single_view"])
@pytest.mark.parametrize("w", [2, 4])
def test_sharded_engine_matches_unsharded(runs, w, mode):
    got, want = runs["out"][w][mode], runs["unsharded"][mode]
    assert want["capacity"] > 32  # the capacity doubled inside the run
    assert (got["capacity"], got["fields"]) == (want["capacity"], want["fields"])
    trained = [d for d in want["losses"] if d]
    assert trained and len(got["losses"]) == len(want["losses"])
    for a, b in zip(got["losses"], want["losses"]):
        assert set(a) == set(b)
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-6), (k, a[k], b[k])
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k], atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["render"], want["render"], atol=1e-6)


def test_checkpoint_at_two_ranks_loads_at_one_and_in_jax(runs):
    from neural_graph_mapping_tpu import run_mapping as jrun
    from neural_graph_mapping_tpu_torch import run_mapping

    tmp = runs["tmp"]
    path = tmp / "ckpt_w2.npz"
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    one = run_mapping.NeuralGraphMapRunner(runner_config(1, tmp / "one", RESUME_DS_CFG), "cpu")
    one.load_model(path)
    for k, v in one.engine._params.items():
        np.testing.assert_array_equal(v.numpy(), data[f"params.{k}"], err_msg=k)
    # saved again at W = 1: the same keys, layouts and values
    with np.load(one.save_model(tmp / "ckpt_w1.npz", full=True)) as npz:
        assert set(npz.files) == set(data)
        for k in npz.files:
            np.testing.assert_array_equal(npz[k], data[k], err_msg=k)
    ds = _dataset(RESUME_DS_CFG)
    img, _ = one.engine.render_image(ds.get_slam_c2ws(5), ds.camera.scaled_camera(0.25))
    np.testing.assert_allclose(img.numpy(), runs["out"][2]["checkpoint_render"], atol=1e-6)

    jcfg = dict(runner_config(1, tmp / "jax", RESUME_DS_CFG))
    jrunner = jrun.NeuralGraphMapRunner(jcfg)
    jrunner.load_model(path)
    for k, v in jrunner.engine._params.items():
        np.testing.assert_array_equal(np.asarray(v), data[f"params.{k}"], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jrunner.engine._adam.steps), data["resume.adam_steps"])
    assert jrunner.engine.num_fields == int(data["num_fields"]) > 0


@pytest.mark.parametrize("size", [2, 3, 8])
def test_pad_fields_to_group_as_jax_pads_to_its_mesh(size):
    """Zero rows up to a multiple of the group's size, as JAX's
    ``pad_fields_to_mesh`` pads to its mesh's (here 8 devices)."""
    import jax
    import jax.numpy as jnp

    from neural_graph_mapping_tpu.parallel import sharding as jshd
    from neural_graph_mapping_tpu_torch.parallel import sharding

    tree = {"a": np.arange(13 * 3, dtype=np.float32).reshape(13, 3), "b": np.ones((13,), np.int32)}
    got = sharding.pad_fields_to_group({k: torch.from_numpy(v) for k, v in tree.items()}, size)
    for k, v in tree.items():
        assert got[k].shape[0] == -(-13 // size) * size and got[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(got[k][:13].numpy(), v)
        assert not got[k][13:].any()
    if size == 8:
        want = jshd.pad_fields_to_mesh({k: jnp.asarray(v) for k, v in tree.items()}, jshd.make_field_mesh(8))
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    del jax


def test_full_resume_at_two_ranks_is_bit_for_bit(runs):
    diffs = runs["out"][2]["resume_diffs"]
    assert diffs and all(v == 0.0 for v in diffs.values()), {k: v for k, v in diffs.items() if v}


@pytest.mark.parametrize("backend", [[], ["--dist-backend", "gloo"]], ids=["no_backend", "gloo"])
def test_cli_without_torchrun_names_it(tmp_path, monkeypatch, backend):
    """num_field_shards > 1 outside a torchrun launch raises before any
    work, naming torchrun; so does nccl asked for on the CPU."""
    from neural_graph_mapping_tpu_torch import run_mapping

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(engine_config(2), dataset_type=SYNTHETIC, dataset_config=DS_CFG)))
    argv = ["--config", str(path), "--device", "cpu", "--out_dir", str(tmp_path / "runs"), *backend]
    with pytest.raises((RuntimeError, ValueError), match="torchrun --nproc_per_node=2"):
        run_mapping.main(argv)
    with pytest.raises(ValueError, match="--device cpu needs --dist-backend gloo"):
        run_mapping.main(argv[:6] + ["--dist-backend", "nccl"])
    assert not (tmp_path / "runs").exists()


def _cli(tmp_path, w, out_dir):
    """Start the CLI of a W-rank run (torchrun for W > 1) -> (process,
    out_dir)."""
    cfg = dict(engine_config(w), dataset_type=SYNTHETIC, dataset_config=DS_CFG, eval_ratio=0.34,
               eval_metrics=["psnr", "depthl1"], mesh_resolution=0.4, block_size=16384,
               eval_store_details=False, out_dir=str(out_dir))
    path = tmp_path / f"cli_w{w}.json"
    path.write_text(json.dumps(cfg))
    args = ["-m", "neural_graph_mapping_tpu_torch.run_mapping", "--config", str(path), "--device", "cpu"]
    if w > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={w}",
               *args, "--dist-backend", "gloo"]
    else:
        cmd = [sys.executable, *args]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out_dir


def _cli_result(proc, out_dir):
    """The metrics the run printed and its checkpoint."""
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-6000:]
    metrics = [line for line in stdout.splitlines() if line.startswith("{")]
    assert len(metrics) == 1  # rank 0 alone prints
    runs_ = list(out_dir.iterdir())
    assert len(runs_) == 1
    ckpts = list(runs_[0].glob("*.npz"))
    assert len(ckpts) == 1 and list((runs_[0] / "eval_data").glob("*final.ply"))
    return json.loads(metrics[0]), ckpts[0]


def test_cli_under_torchrun_writes_the_unsharded_checkpoint(tmp_path):
    """torchrun --nproc_per_node 2 of the CLI on the CPU (gloo) against a
    W = 1 run of the same config, both at once: npz keys, shapes (the
    feature-major layout) and values, and the metrics."""
    started = [_cli(tmp_path, w, tmp_path / f"w{w}") for w in (1, 2)]
    (m1, c1), (m2, c2) = (_cli_result(*s) for s in started)
    assert set(m1) == set(m2) and m2["num_fields"] == m1["num_fields"] > 0
    with np.load(c1) as a, np.load(c2) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(b[k], a[k], atol=1e-6, err_msg=k)
    for k in ("final_psnr", "final_depthl1"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, err_msg=k)
