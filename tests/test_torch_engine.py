"""The whole ported slice against the JAX package on the CPU: one
optimization iteration on identical weights and replayed draws, and the
online loop's field allocation over a few frames. Also pins chip_smoke.py's
written-out config to the YAML files it stands for."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch

from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping import map_state as jmap_state
from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
from neural_graph_mapping_tpu.mapping import render as jrender
from neural_graph_mapping_tpu.mapping import sampling as jsampling
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu_torch import config as tconfig
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, sampling
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import permuto


def tiny_config(**overrides):
    cfg = {
        "model_kwargs": {
            "dim_points": 3,
            "field_type": "neural_graph_mapping_tpu.models.fields.NeuralField",
            "field_kwargs": {
                "encoding_type": "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
                "encoding_kwargs": {
                    "pos_dim": 3, "log2_hashmap_size": 8, "nr_levels": 4,
                    "nr_feat_per_level": 2, "coarsest_scale": 1.0, "finest_scale": 0.01,
                    "init_scale": 1e-2,
                },
                "num_layers": 1,
                "dim_out": 4,
            },
            "num_knn": 2, "distance_factor": 10.0, "field_radius": 1.0,
            "scale_mode": "unit_cube", "outside_value": 1.0,
        },
        "field_radius": 1.0,
        "num_train_fields": 4,
        "num_rays_per_field": 32,
        "num_samples_coarse": 4,
        "num_samples_depth_guided": 8,
        "num_iterations_per_frame": 1,
        "num_kf_slots": 8,
        "max_new_fields": 64,
        "geometry_mode": "nrgbd",
        "geometry_factor": 20.0,
        "truncation_distance": 0.1,
        "learning_rate": 1e-3,
        "adam_eps": 1e-15,
        "adam_weight_decay": 1e-5,
    }
    cfg.update(overrides)
    return cfg


DS_CFG = {"num_frames": 12, "width": 40, "height": 30, "fx": 35.0, "fy": 35.0}


@pytest.fixture(scope="module")
def iteration_state():
    """A realistic map state for one iteration: fields allocated from frame
    0's depth, four cached frames, JAX-initialized weights."""
    cfg = tiny_config()
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    jds = JaxSynthetic(DS_CFG)
    cap, s = 64, cfg["num_kf_slots"]
    frames = [2, 0, 5, 10]  # slot 0 = current frame, then keyframes
    cache_rgb = np.zeros((s, 30, 40, 3), np.float32)
    cache_depth = np.zeros((s, 30, 40), np.float32)
    cache_c2w = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
    for slot, fid in enumerate(frames):
        cache_rgb[slot] = ds[fid]["rgbd"][..., :3]
        cache_depth[slot] = ds[fid]["rgbd"][..., 3]
        cache_c2w[slot] = ds.gt_c2ws[fid]
    cache_valid = np.arange(s) < len(frames)
    centers, n_new, _, _ = engine.allocate_fields_jit(
        ds.camera, 1.0, 64, torch.from_numpy(cache_depth[1]), torch.from_numpy(cache_c2w[1]),
        torch.zeros((cap, 3)), torch.zeros((cap,), dtype=torch.bool),
        generator=torch.Generator().manual_seed(0),
    )
    n = int(n_new)
    positions = np.zeros((cap, 3), np.float32)
    positions[:n] = to_np(centers)[:n]
    orientations = np.zeros((cap, 4), np.float32)
    orientations[:, 0] = 1.0
    allocated = np.arange(cap) < n
    observed = to_np(sampling.observed_fields_mask(
        ds.camera, torch.from_numpy(cache_depth[0]), torch.from_numpy(cache_c2w[0]),
        torch.from_numpy(positions), torch.from_numpy(allocated), 1.0,
        generator=torch.Generator().manual_seed(1),
    ))
    jfs = JaxFieldSet(**cfg["model_kwargs"])
    params = {k: np.asarray(v) for k, v in jfs.init_fields(jax.random.PRNGKey(3), cap).items()}
    return dict(
        cfg=cfg, ds=ds, jcam=jds.camera, jfs=jfs, tfs=NeuralFieldSet(**cfg["model_kwargs"]),
        n=n, params=params, positions=positions, orientations=orientations,
        allocated=allocated, observed=observed, cache_rgb=cache_rgb, cache_depth=cache_depth,
        cache_c2w=cache_c2w, cache_valid=cache_valid,
    )


def _configs(cfg):
    rcfg = jrender.RenderConfig(
        geometry_mode="nrgbd", geometry_factor=20.0, num_samples_coarse=cfg["num_samples_coarse"],
        num_samples_depth_guided=cfg["num_samples_depth_guided"], range_depth_guided=0.1,
        truncation_distance=0.1,
    )
    ocfg = joptimizer.AdamConfig(learning_rate=1e-3, eps=1e-15, weight_decay=1e-5)
    lcfg = jengine.LossConfig(num_rays_per_field=cfg["num_rays_per_field"])
    tl = engine.LossConfig(**{k: getattr(lcfg, k) for k in engine.LossConfig._fields})
    from neural_graph_mapping_tpu_torch.mapping import optimizer, render

    return rcfg, ocfg, lcfg, render.RenderConfig(**rcfg._asdict()), optimizer.AdamConfig(**ocfg._asdict()), tl


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _iteration_arrays(key, n_cap, f, r, s, sc, sg):
    """JAX's draws of one optimization_iteration, in its split order, as
    one program."""
    k_sel, k_sample, k_render = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_sel)
    k_off, k_kf, k_pix = jax.random.split(k_sample, 3)
    kr1, kr2 = jax.random.split(k_render)
    return (jax.random.uniform(k1, (n_cap,)), jax.random.uniform(k2, (n_cap,)),
            jax.random.normal(k_off, (20, 3)), jax.random.gumbel(k_kf, (f, r, s)),
            jax.random.uniform(k_pix, (f, r, 2)), jax.random.uniform(kr1, (f, r, sc)),
            jax.random.uniform(kr2, (f, r, sg)))


def _replayed_draws(key, n_cap, f, r, s, sc, sg):
    """JAX's draws of one optimization_iteration as the port's IterationDraws."""
    return engine.IterationDraws(*(to_torch(a) for a in _iteration_arrays(key, n_cap, f, r, s, sc, sg)))


def test_one_iteration_matches_jax(iteration_state):
    """Losses within 1e-4 relative and every parameter gradient within
    1e-5, on identical weights, the same target and JAX's own draws."""
    _check_iteration_against_jax(iteration_state, iteration_state["tfs"])


def test_fused_mlp_iteration_matches_jax(iteration_state):
    """With ``fused_mlp: true`` the port trains through encode_mlp_fused
    (the plain versions on the CPU); JAX's CPU iteration, which takes the
    unfused route there, is the reference: the same tolerances."""
    tfs = engine.NeuralGraphMap(tiny_config(fused_mlp=True), "cpu")._fset
    assert tfs.prototype.fused_mlp
    calls = []
    orig = permuto.encode_mlp_fused

    def spy(*args):
        calls.append(1)
        return orig(*args)

    permuto.encode_mlp_fused = spy
    try:
        _check_iteration_against_jax(iteration_state, tfs)
    finally:
        permuto.encode_mlp_fused = orig
    assert calls  # the iteration went through the fused route


def _check_iteration_against_jax(st, tfs):
    cfg = st["cfg"]
    f, r, cap = cfg["num_train_fields"], cfg["num_rays_per_field"], st["params"]["w0"].shape[0]
    s = st["cache_c2w"].shape[0]
    rcfg, ocfg, lcfg, trcfg, tocfg, tlcfg = _configs(cfg)
    key = jax.random.PRNGKey(42)

    jp = {k: jnp.asarray(v) for k, v in st["params"].items()}
    jcache = (
        jnp.asarray(st["cache_rgb"], jnp.bfloat16), jnp.asarray(st["cache_depth"]),
        jnp.asarray(st["cache_c2w"]), jnp.asarray(st["cache_valid"]),
    )
    jmaps = (jnp.asarray(st["positions"]), jnp.asarray(st["orientations"]),
             jnp.asarray(st["allocated"]), jnp.asarray(st["observed"]))
    _, _, want_ti, want_losses = jengine.optimization_iteration(
        st["jfs"], st["jcam"], rcfg, ocfg, lcfg, f, jp, joptimizer.init_adam_state(jp),
        jnp.zeros((cap,), jnp.int32), jmaps[0], jmaps[1], jmaps[2], jmaps[3], *jcache, key,
    )

    tp = interop.params_from_jax(st["params"], "cpu")
    tcache = (
        torch.from_numpy(st["cache_rgb"]).to(torch.bfloat16), torch.from_numpy(st["cache_depth"]),
        torch.from_numpy(st["cache_c2w"]), torch.from_numpy(st["cache_valid"]),
    )
    tmaps = tuple(torch.from_numpy(st[k]) for k in ("positions", "orientations", "allocated", "observed"))
    draws = _replayed_draws(key, cap, f, r, s, cfg["num_samples_coarse"], cfg["num_samples_depth_guided"])
    from neural_graph_mapping_tpu_torch.mapping import optimizer

    ti = torch.zeros((cap,), dtype=torch.int32)
    _, _, got_ti, got_losses = engine.optimization_iteration(
        tfs, st["ds"].camera, trcfg, tocfg, tlcfg, f, tp, optimizer.init_adam_state(tp),
        ti, *tmaps, *tcache, draws=draws,
    )
    assert set(got_losses) == set(want_losses)
    for k in want_losses:
        assert_close(want_losses[k], got_losses[k], atol=1e-7, rtol=1e-4, err_msg=k)
    assert float(got_losses["diag_valid_fields"]) == f
    np.testing.assert_array_equal(to_np(got_ti), np.asarray(want_ti))

    # gradients: the JAX core's loss_fn under jax.value_and_grad, against
    # the port's loss_and_grads on its own target from the same draws
    k_sel, k_sample, k_render = jax.random.split(key, 3)
    ids, valid = jsampling.select_target_fields(k_sel, jmaps[3], jmaps[2], f)
    target = jsampling.sample_target_mv(
        k_sample, st["jcam"], ids, valid, jmaps[0], *jcache, 1.0, r,
    )
    sub = st["jfs"].gather_fields(jp, target.field_ids)

    def loss_fn(sp):
        pred = jrender.render_rays_vmap(
            st["jfs"], sp, jmaps[0][target.field_ids], jmaps[1][target.field_ids],
            st["jcam"], target, k_render, rcfg,
        )
        return jengine.compute_losses(lcfg, rcfg, target, pred)

    (_, _), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(sub)
    t_ids, t_valid = sampling.select_target_fields(tmaps[3], tmaps[2], f, draws.u_obs, draws.u_rand)
    t_target = sampling.sample_target_mv(
        st["ds"].camera, t_ids, t_valid, tmaps[0], *tcache, 1.0, r,
        offsets=draws.offsets, kf_gumbel=draws.kf_gumbel, pix_u=draws.pix_u,
    )
    np.testing.assert_array_equal(to_np(t_target.field_ids), np.asarray(target.field_ids))
    np.testing.assert_array_equal(to_np(t_target.ijs), np.asarray(target.ijs))
    # the iteration above stepped tp in place: take the gradient at the
    # weights JAX took it at
    tp = interop.params_from_jax(st["params"], "cpu")
    t_sub = tfs.gather_fields(tp, t_target.field_ids)
    _, got_grads = engine.loss_and_grads(
        tfs, st["ds"].camera, trcfg, tlcfg, t_sub, tmaps[0][t_target.field_ids],
        tmaps[1][t_target.field_ids], t_target, draws,
    )
    assert set(got_grads) == set(want_grads)
    for k in want_grads:
        assert_close(want_grads[k], got_grads[k], atol=1e-5, err_msg=k)
    assert float(got_grads["enc.table"].abs().max()) > 1e-4  # the encoding trains


def test_process_frame_allocates_like_jax():
    """Six frames (two keyframes) of the online loop at 64x48: the port
    allocates the same fields as JAX when it replays JAX's grid shifts, and
    its losses are finite."""
    cfg = tiny_config()
    ds_cfg = {"num_frames": 12, "width": 64, "height": 48, "fx": 56.0, "fy": 56.0}
    jds = JaxSynthetic(ds_cfg)
    jds.load_slam_results()
    ds = SyntheticDataset(ds_cfg)
    ds.load_slam_results()
    base_key = jax.random.PRNGKey(cfg.get("seed", 0) + 1)
    cell = jmap_state.field_cell_size(cfg["field_radius"])
    orig_alloc = engine.allocate_fields_jit

    class ReplayingMap(engine.NeuralGraphMap):
        def _allocate_new_fields(self, frame_id, depth, c2w, kf_slot):
            # the JAX engine's allocation key for this frame counter
            key = jax.random.fold_in(base_key, 100000 + self._frame_counter)
            shift = to_torch(jax.random.uniform(key, (3,), minval=0.0, maxval=cell))

            def alloc(*args, **kwargs):
                kwargs["shift"] = shift
                return orig_alloc(*args, **kwargs)

            engine.allocate_fields_jit = alloc
            try:
                super()._allocate_new_fields(frame_id, depth, c2w, kf_slot)
            finally:
                engine.allocate_fields_jit = orig_alloc

    jngm = jengine.NeuralGraphMap(cfg)
    tngm = ReplayingMap(cfg, "cpu")
    for fid in range(6):
        jngm.process_frame(jds, fid, jnp.asarray(jds[fid]["rgbd"]))
        losses = tngm.process_frame(ds, fid, ds[fid]["rgbd"])
        assert tngm.num_fields == jngm.num_fields > 0, fid
        assert losses and all(np.isfinite(v) for v in losses.values())
    n = tngm.num_fields
    assert_close(np.asarray(jngm._map_arrays.positions)[:n], tngm._map_arrays.positions[:n], atol=1e-5)
    assert tngm._kf2fields == jngm._kf2fields
    assert int(tngm._map_arrays.training_iterations.sum()) > 0


def test_render_between_frames_leaves_training_draws():
    """Two maps of one seed train on the same four frames; one of them
    renders a 16x12 image after frame 1, as a live preview does. A render
    draws its jitter from the init stream (JAX's ``_key``), never from the
    frame programs' stream, so both end with equal parameters and training
    counts."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    cfg = tiny_config(eval_span_samples=32, pixel_block_size=512)
    previewed, plain = engine.NeuralGraphMap(cfg, "cpu"), engine.NeuralGraphMap(cfg, "cpu")
    cam = ds.camera.scaled_camera(0.4)
    assert (cam.width, cam.height) == (16, 12)
    for fid in range(4):
        for ngm in (previewed, plain):
            ngm.process_frame(ds, fid, ds[fid]["rgbd"])
        if fid == 1:
            init_state = previewed._init_gen.get_state()
            rgbd, _ = previewed.render_image(ds[fid]["c2w"], cam)
            assert rgbd.shape == (12, 16, 4) and bool(torch.isfinite(rgbd).all())
            assert not torch.equal(previewed._init_gen.get_state(), init_state)  # the render drew
    assert previewed.capacity == plain.capacity and previewed.num_fields == plain.num_fields > 0
    for k, v in plain._params.items():
        assert torch.equal(previewed._params[k], v), k
    ti = plain._map_arrays.training_iterations
    assert int(ti.sum()) > 0
    assert torch.equal(previewed._map_arrays.training_iterations, ti)


def test_chip_smoke_config_equals_yaml():
    """chip_smoke.py writes the production config out (the card's machine
    may lack PyYAML); it must equal what the loader gives for the files."""
    import chip_smoke

    want = tconfig.load_config("neural_graph_map.yaml")
    want = tconfig.load_config("synthetic.yaml", want)
    assert chip_smoke.CONFIG == want


def test_str_to_object_maps_the_jax_prefix():
    from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

    got = tconfig.str_to_object("neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding")
    assert got is PermutohedralEncoding
    assert tconfig.str_to_object(
        "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset"
    ) is SyntheticDataset
    with pytest.raises(ImportError):
        tconfig.str_to_object("neural_graph_mapping_tpu.nope.Missing")


def test_fused_mlp_key_defaults_off_and_is_validated():
    assert not engine.NeuralGraphMap(tiny_config(), "cpu")._fset.prototype.fused_mlp
    with pytest.raises(ValueError, match="true or false"):
        engine.NeuralGraphMap(tiny_config(fused_mlp="yes"), "cpu")


def _with_field(cfg, **field_overrides):
    mk = dict(cfg["model_kwargs"])
    fk = dict(mk["field_kwargs"])
    enc = dict(fk["encoding_kwargs"])
    for key, value in field_overrides.items():
        (enc if key == "concat_points" else fk)[key] = value
    fk["encoding_kwargs"] = enc
    mk["field_kwargs"] = fk
    return {**cfg, "model_kwargs": mk}


@pytest.mark.parametrize(
    "field", [dict(skip_mode="add"), dict(num_layers=2), dict(concat_points=True),
              dict(dim_mlp_out=64)],
    ids=["skip_mode", "two_layers", "concat_points", "hidden_64"],
)
def test_fused_mlp_refuses_fields_the_kernels_cannot_take(field):
    """JAX falls back silently; the port raises at construction."""
    cfg = _with_field(tiny_config(fused_mlp=True), **field)
    with pytest.raises(ValueError, match="fused_mlp needs"):
        engine.NeuralGraphMap(cfg, "cpu")
    engine.NeuralGraphMap({**cfg, "fused_mlp": False}, "cpu")  # the same field, unfused


def test_unported_modes_raise():
    """An unknown update_mode raises (the JAX engine trains nothing with
    one); field-axis sharding needs a process group of num_field_shards
    ranks (the error names torchrun) and a capacity the shard count
    divides, as JAX's; both update modes build."""
    with pytest.raises(ValueError, match="update_mode"):
        engine.NeuralGraphMap(tiny_config(update_mode="sv"), "cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        engine.NeuralGraphMap(tiny_config(num_field_shards=2), "cpu")
    with pytest.raises(ValueError, match="divisible by num_field_shards=3"):
        engine.NeuralGraphMap(tiny_config(num_field_shards=3), "cpu")
    for mode in ("multi_view", "single_view"):
        assert engine.NeuralGraphMap(tiny_config(update_mode=mode), "cpu")._update_mode == mode


def test_map_needs_explicit_device(monkeypatch):
    """The map runs on the card unless the caller passes 'cpu': without
    CUDA the default raises instead of falling back; None raises too."""
    import inspect

    assert inspect.signature(engine.NeuralGraphMap).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.NeuralGraphMap(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.NeuralGraphMap(tiny_config(), "cuda:0")
    with pytest.raises(ValueError, match="needs a device"):
        engine.NeuralGraphMap(tiny_config(), None)
    ngm = engine.NeuralGraphMap(tiny_config(), "cpu")
    assert ngm._params["w0"].device.type == "cpu"
