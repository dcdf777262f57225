"""The port's single-view update mode against the JAX package on the CPU:
``sampling.sample_target_sv`` on JAX's own draws and by statistics on the
port's generator, single-view iterations against JAX's
``optimization_iterations_scan_sv`` on replayed draws (both training
routes), ``process_frame`` with ``update_mode: single_view``, and its draw
stream (the init / render stream, as JAX's ``_next_key()``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch
from test_torch_engine import DS_CFG, _configs, iteration_state, tiny_config  # noqa: F401 (fixture)

from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
from neural_graph_mapping_tpu.mapping import sampling as jsampling
from neural_graph_mapping_tpu_torch import geometry, interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, optimizer, sampling
from neural_graph_mapping_tpu_torch.utils import transforms


def _cloud_draws(key, jcam, rgbd, n_cap, f, r, num_cloud):
    """JAX's draws inside sample_target_sv, in its split order."""
    k_cloud, k_fields, k_rays = jax.random.split(key, 3)
    _, _, valid = jcam.depth_to_points_full(jnp.asarray(rgbd[..., 3]), "opengl")
    cloud = jax.random.categorical(k_cloud, jnp.log(jnp.where(valid, 1.0, 1e-20)), shape=(num_cloud,))
    return dict(cloud_idx=to_torch(cloud).long(), u_fields=to_torch(jax.random.uniform(k_fields, (n_cap,))),
                u_rays=to_torch(jax.random.uniform(k_rays, (f, r))))


def _sv_inputs(st, active_count=None):
    rgbd = np.concatenate([st["cache_rgb"][0], st["cache_depth"][0][..., None]], -1).astype(np.float32)
    active = st["allocated"].copy()
    if active_count is not None:
        active[np.flatnonzero(active)[active_count:]] = False
    return rgbd, st["cache_c2w"][0], st["positions"], active


@pytest.mark.parametrize(
    "num_cloud,chunk,active_count", [(20_000, 8192, None), (5_000, 1024, 2)],
    ids=["20k-cloud", "5k-cloud-two-active"],
)
def test_sample_target_sv_matches_jax_draws(iteration_state, num_cloud, chunk, active_count):
    """JAX's cloud indices, field uniforms and ray uniforms replayed: the
    integer outputs (pixels, field ids, validity, masks) exact, the floats
    within 1e-6. With two active fields, slots past them are invalid: their
    field id is arbitrary in both packages (a top-k among -inf scores), so
    the values that depend on it (the id, near / far, termination) are
    compared on the valid slots; their rays, drawn over the whole cloud,
    are compared all."""
    st = iteration_state
    f, r = st["cfg"]["num_train_fields"], st["cfg"]["num_rays_per_field"]
    rgbd, c2w, positions, active = _sv_inputs(st, active_count)
    key = jax.random.PRNGKey(21)
    want = jsampling.sample_target_sv(
        key, st["jcam"], jnp.asarray(rgbd), jnp.asarray(c2w), jnp.asarray(positions), jnp.asarray(active),
        1.0, f, r, num_cloud_points=num_cloud, cloud_chunk=chunk,
    )
    draws = _cloud_draws(key, st["jcam"], rgbd, len(active), f, r, num_cloud)
    got = sampling.sample_target_sv(
        st["ds"].camera, torch.from_numpy(rgbd), torch.from_numpy(c2w), torch.from_numpy(positions),
        torch.from_numpy(active), 1.0, f, r, num_cloud_points=num_cloud, cloud_chunk=chunk, **draws,
    )
    valid = to_np(got.field_valid)
    np.testing.assert_array_equal(valid, np.asarray(want.field_valid))
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), to_np(getattr(got, name))
        assert w.shape == g.shape, name
        if name in ("field_ids", "near_distances", "far_distances", "term_probs"):
            w, g = w[valid], g[valid]
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert_close(w, g, atol=1e-6, err_msg=name)
    assert valid.sum() == (f if active_count is None else min(f, active_count))
    assert to_np(got.depth_mask)[valid].mean() > 0.3


def test_sample_target_sv_statistics(iteration_state):
    """On the port's own generator: the chosen fields are distinct and
    eligible (at least R cloud segments cross their sphere, by a dense
    count); every ray's segment crosses its field's sphere; every drawn
    pixel has depth; over many draws each eligible field is chosen about
    equally often."""
    st = iteration_state
    f, r = st["cfg"]["num_train_fields"], st["cfg"]["num_rays_per_field"]
    rgbd, c2w, positions, active = (torch.from_numpy(a) for a in _sv_inputs(st))
    cam = st["ds"].camera
    gen = torch.Generator().manual_seed(0)
    picks = np.zeros(len(active))
    n_draws = 60
    for i in range(n_draws):
        t = sampling.sample_target_sv(cam, rgbd, c2w, positions, active, 1.0, f, r, num_cloud_points=4000,
                                      cloud_chunk=1024, generator=gen)
        ids = to_np(t.field_ids)[to_np(t.field_valid)]
        assert len(set(ids)) == len(ids) == f
        picks[ids] += 1
        if i == 0:  # rays against their spheres
            pts_c = cam.ijs_to_directions(t.ijs.float(), "opengl") * (t.gt_distances[..., None])
            pos_c = transforms.transform_points(positions, c2w, inv=True)[t.field_ids]
            for fi in range(f):
                hit = geometry.segments_intersect_spheres(
                    torch.zeros_like(pts_c[fi]), pts_c[fi], pos_c[fi][None], 1.0 + 1e-4)
                assert bool(hit.all()), fi
            assert bool((t.rgbds[..., 3] > 0).all())
    # eligibility by a dense count over one large cloud of the valid pixels
    points, _, valid = cam.depth_to_points_full(rgbd[..., 3], "opengl")
    pos_c = transforms.transform_points(positions, c2w, inv=True)
    hits = geometry.segments_intersect_spheres(torch.zeros_like(points), points, pos_c, 1.0) & valid[None]
    share = to_np(hits.float().sum(-1)) / float(valid.sum())
    eligible = (share * 4000 >= r) & to_np(active)
    chosen = picks > 0
    assert not (chosen & (share * 4000 < 0.5 * r)).any()  # never a field far below R hits
    frac = picks[eligible & (share > 0.05)] / n_draws
    assert len(frac) >= f and np.abs(frac - f / eligible.sum()).max() < 0.35


def _replayed_sv_draws(key, jcam, cache_rgb, cache_depth, cache_valid, n_cap, f, r, sc, sg, num_iters):
    """JAX's draws of optimization_iterations_scan_sv, iteration by
    iteration, in its split order; the view each iteration trains on
    decides which cached frame the cloud is drawn from."""
    out = []
    for i, sub in enumerate(jax.random.split(key, num_iters)):
        k_slot, k_target, k_render = jax.random.split(sub, 3)
        gumbel = jax.random.gumbel(k_slot, cache_valid.shape)
        others = cache_valid.copy()
        others[0] = False
        slot = 0 if (i % 2 and cache_valid[0]) else int(np.argmax(np.asarray(gumbel) + np.where(others, 0.0, -np.inf)))
        rgbd = np.concatenate([cache_rgb[slot], cache_depth[slot][..., None]], -1)
        kr1, kr2 = jax.random.split(k_render)
        out.append(engine.IterationDraws(
            slot_gumbel=to_torch(gumbel),
            u_coarse=to_torch(jax.random.uniform(kr1, (f, r, sc))),
            u_guided=to_torch(jax.random.uniform(kr2, (f, r, sg))),
            **_cloud_draws(k_target, jcam, rgbd, n_cap, f, r, 50_000),
        ))
    return out


@pytest.mark.parametrize("fused_mlp", [False, True], ids=["unfused", "fused_mlp"])
def test_sv_iterations_match_jax(iteration_state, fused_mlp):
    """Two single-view iterations (a random keyframe, then the current
    frame) on JAX's replayed draws: every parameter leaf and the last
    losses within 1e-4 relative, training counts exact. Every target slot
    is a distinct valid field, so the Adam write-back agrees (see ROADMAP
    §3 for the invalid-slot divergence). With ``fused_mlp`` the port trains
    through encode_mlp_fused; JAX's CPU reference takes the unfused route."""
    st = iteration_state
    cfg = st["cfg"]
    f, r, cap = cfg["num_train_fields"], cfg["num_rays_per_field"], st["params"]["w0"].shape[0]
    rcfg, ocfg, lcfg, trcfg, tocfg, tlcfg = _configs(cfg)
    key = jax.random.PRNGKey(5)
    active = st["allocated"]
    cache = (st["cache_rgb"], st["cache_depth"], st["cache_c2w"], st["cache_valid"])

    jp = {k: jnp.array(v) for k, v in st["params"].items()}
    want_p, _, want_ti, want_losses = jengine.optimization_iterations_scan_sv(
        st["jfs"], st["jcam"], rcfg, ocfg, lcfg, f, 2, jp, joptimizer.init_adam_state(jp),
        jnp.zeros((cap,), jnp.int32), jnp.asarray(st["positions"]), jnp.asarray(st["orientations"]),
        jnp.asarray(active), jnp.asarray(cache[0], jnp.bfloat16), jnp.asarray(cache[1]),
        jnp.asarray(cache[2]), jnp.asarray(cache[3]), key,
    )

    tfs = engine.NeuralGraphMap(tiny_config(fused_mlp=fused_mlp), "cpu")._fset
    tp = interop.params_from_jax(st["params"], "cpu")
    adam = optimizer.init_adam_state(tp)
    ti = torch.zeros((cap,), dtype=torch.int32)
    rgb_bf16 = torch.from_numpy(cache[0]).to(torch.bfloat16)
    draws = _replayed_sv_draws(key, st["jcam"], rgb_bf16.float().numpy(), cache[1], cache[3], cap, f, r,
                               cfg["num_samples_coarse"], cfg["num_samples_depth_guided"], 2)
    tcache = (rgb_bf16, torch.from_numpy(cache[1]), torch.from_numpy(cache[2]), torch.from_numpy(cache[3]))
    for i, d in enumerate(draws):
        tp, adam, ti, losses = engine.optimization_iteration_sv(
            tfs, st["ds"].camera, trcfg, tocfg, tlcfg, f, i, tp, adam, ti, torch.from_numpy(st["positions"]),
            torch.from_numpy(st["orientations"]), torch.from_numpy(active), *tcache, draws=d,
        )
        assert float(losses["diag_valid_fields"]) == f
    np.testing.assert_array_equal(to_np(ti), np.asarray(want_ti))
    assert int(ti.sum()) == 2 * f
    for k in want_losses:
        assert_close(want_losses[k], losses[k], atol=1e-7, rtol=1e-4, err_msg=k)
    for k, w in want_p.items():
        w = np.asarray(w)
        assert_close(w, tp[k], atol=1e-4 * float(np.abs(w).max()), err_msg=k)
    assert not np.array_equal(to_np(tp["enc.table"]), st["params"]["enc.table"])  # the encoding trained


def test_process_frame_single_view():
    """Eight frames with update_mode: single_view (the JAX package's
    TestSingleViewMode): fields allocated, finite losses every trained
    frame, training counts that rise; only BFS-active fields train."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(tiny_config(update_mode="single_view", num_iterations_per_frame=2), "cpu")
    totals = []
    for fid in range(8):
        losses = ngm.process_frame(ds, fid, ds[fid]["rgbd"])
        if ngm.num_fields:
            assert losses and all(np.isfinite(v) for v in losses.values()), fid
            assert "combined" in losses and losses["diag_valid_fields"] > 0
        totals.append(int(ngm._map_arrays.training_iterations.sum()))
    assert ngm.num_fields > 0 and ngm._observed_mask is None  # no observed-field test in this mode
    assert totals[-1] > totals[0] and all(b >= a for a, b in zip(totals, totals[1:]))
    ti = to_np(ngm._map_arrays.training_iterations)
    active = np.zeros(ngm.capacity, bool)
    for fid in range(8):
        active[ngm._active_field_ids(fid)] = True
    assert (ti[~active] == 0).all() and (ti[active] > 0).any()


def test_single_view_draw_stream():
    """Single-view frames draw from the init / render stream, as JAX's scan
    takes _next_key(): two maps of one seed stay equal; the frame stream
    moves only with field allocation (equal to a map that trains nothing);
    and a render between frames moves later single-view draws (JAX's too)."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    cfg = tiny_config(update_mode="single_view", eval_span_samples=32, pixel_block_size=512)
    a, b, c = (engine.NeuralGraphMap(cfg, "cpu") for _ in range(3))
    idle = engine.NeuralGraphMap({**cfg, "num_iterations_per_frame": 0}, "cpu")
    for fid in range(4):
        for ngm in (a, b, c, idle):
            ngm.process_frame(ds, fid, ds[fid]["rgbd"])
        if fid == 1:
            c.render_image(ds[fid]["c2w"], ds.camera.scaled_camera(0.4))
    for k, v in a._params.items():
        assert torch.equal(b._params[k], v), k
    assert torch.equal(a._frame_gen.get_state(), idle._frame_gen.get_state())
    assert not torch.equal(a._init_gen.get_state(), idle._init_gen.get_state())
    assert a.num_fields == c.num_fields > 0 and int(a._map_arrays.training_iterations.sum()) > 0
    assert not torch.equal(c._params["enc.table"], a._params["enc.table"])


def test_cli_single_view_on_cpu(tmp_path):
    """The shipped configs through the port's CLI with the override
    ``--update_mode single_view``, on the CPU, the scene cut to 12 frames at
    40x30: the run trains and scores its held-out frame."""
    import yaml

    from neural_graph_mapping_tpu_torch import run_mapping

    run_mapping.main([
        "--config", "neural_graph_map.yaml", "synthetic.yaml", "--device", "cpu",
        "--out_dir", str(tmp_path), "--update_mode", "single_view", "--dataset_config.num_frames", "12",
        "--dataset_config.width", "40", "--dataset_config.height", "30",
        "--dataset_config.fx", "35.0", "--dataset_config.fy", "35.0",
        "--num_iterations_per_frame", "2", "--num_rays_per_field", "64", "--num_train_fields", "8",
        "--eval_ratio", "0.34", "--eval_span_samples", "32", "--extract_mesh", "false",
        "--eval_store_details", "false",
    ])
    saved = yaml.safe_load((next(tmp_path.iterdir()) / "latest_run.yaml").read_text())
    assert saved["update_mode"] == "single_view"
    for k in ("final_psnr", "final_depthl1", "num_fields", "spf_estimate"):
        assert np.isfinite(saved["results"][k]), k
    assert saved["results"]["num_fields"] > 0
