"""The port's triplane, Fourier and NeRF encodings, the field paths they
reach (``apply``, ``apply_vmap``, ``geometry_gradients``, ``apply_knn`` in
2D and 3D, the map's capacity render route and meshing), and the L0
helpers ported with them, against the JAX package on the CPU. These JAX
paths are XLA only: no Pallas kernel is involved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch
from test_torch_engine import DS_CFG, tiny_config

from neural_graph_mapping_tpu import camera as jcamera
from neural_graph_mapping_tpu import geometry as jgeometry
from neural_graph_mapping_tpu.models.fields import NeuralField as JaxField
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu.ops import encodings as jenc
from neural_graph_mapping_tpu.utils import transforms as jtransforms
from neural_graph_mapping_tpu_torch import camera, geometry, interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine
from neural_graph_mapping_tpu_torch.models.fields import NeuralField, NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import encodings
from neural_graph_mapping_tpu_torch.utils import transforms

ENCODINGS = {
    "triplane-sum": ("TriplaneEncoding", dict(resolution=8, num_components=6, init_scale=0.5, mode="sum")),
    "triplane-product": ("TriplaneEncoding", dict(resolution=5, num_components=4, init_scale=1.0, mode="product")),
    "triplane-concat": ("TriplaneEncoding", dict(resolution=7, num_components=3, init_scale=0.5, mode="concat")),
    "fourier-raw": ("PositionalEncodingFourier", dict(dim_in=3, dim_out=19, mu=0.0, sigma=1.0, raw_coords=True)),
    "fourier": ("PositionalEncodingFourier", dict(dim_in=3, dim_out=12, mu=0.5, sigma=2.0, raw_coords=False)),
    "nerf": ("PositionalEncodingNeRF", dict(dim_in=3, num_octaves=4, start_octave=-1)),
}


def _pair(name):
    cls, kw = ENCODINGS[name]
    return getattr(jenc, cls)(**kw), getattr(encodings, cls)(**kw)


def _seeded_like(shapes, seed, scale=0.5):
    """numpy N(0, scale^2) arrays of JAX's parameter shapes (read with
    jax.eval_shape: no compile, no JAX draw)."""
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in shapes.items()}


def _jax_params(jenc_obj, n, seed):
    """n fields' encoding params in JAX's stacked layout (numpy)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return _seeded_like(jax.eval_shape(jax.vmap(jenc_obj.init), keys), seed)


def _set_params(jfs, n, seed):
    """n fields' parameters of a JAX field set, in its layout (numpy)."""
    return _seeded_like(jax.eval_shape(lambda key: jfs.init_fields(key, n), jax.random.PRNGKey(seed)), seed)


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_apply_matches_jax(name):
    """The encode of points in and beyond [-1, 1], with a leading field
    axis (JAX: vmapped over fields) and for one field alone: within 1e-6."""
    je, te = _pair(name)
    params = _jax_params(je, 3, 0)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(je.apply)({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts)))
    got = te.apply(to_torch(params), torch.from_numpy(pts))
    assert got.shape == (3, 5, 7, te.get_out_dim()) == want.shape
    assert_close(want, got, atol=1e-6, err_msg=name)
    one = te.apply({k: torch.from_numpy(np.array(v[1])) for k, v in params.items()}, torch.from_numpy(pts[1]))
    assert_close(want[1], one, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["sum", "product", "concat"])
def test_triplane_exact_at_grid_points(mode):
    """At the grid's own points, the last row and column included (where
    the cell corner is clipped to R - 2), the sample is the plane's value
    and equals JAX's bit for bit."""
    kw = dict(resolution=6, num_components=3, init_scale=1.0, mode=mode)
    je, te = jenc.TriplaneEncoding(**kw), encodings.TriplaneEncoding(**kw)
    params = _jax_params(je, 1, 2)
    planes = params["planes"][0]
    g = -1.0 + 2.0 * np.arange(6) / 5.0
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    want = np.asarray(je.apply({"planes": jnp.asarray(planes)}, jnp.asarray(pts)))
    got = to_np(te.apply({"planes": torch.from_numpy(planes)}, torch.from_numpy(pts)))
    np.testing.assert_array_equal(got, want)
    # at (x, y, z) = grid point (i, j, k): plane 0 holds [:, j, i] (x indexes the width)
    i, j, k = 5, 0, 3
    p = np.asarray([[g[i], g[j], g[k]]], np.float32)
    taps = [planes[0][:, j, i], planes[1][:, k, i], planes[2][:, k, j]]
    one = to_np(te.apply({"planes": torch.from_numpy(planes)}, torch.from_numpy(p)))[0]
    want_one = {"sum": taps[0] + taps[1] + taps[2], "product": taps[0] * taps[1] * taps[2],
                "concat": np.concatenate(taps)}[mode]
    np.testing.assert_allclose(one, want_one, atol=1e-6, rtol=0)


def test_init_draws_from_the_generator():
    """init takes an explicit generator: same seed, same draw; JAX's shapes
    and distributions (planes ~ init_scale N(0, 1), weights ~ mu + sigma N)."""
    cases = {"triplane-sum": ("planes", (64, 3, 6, 8, 8), 0.0, 0.5),
             "fourier": ("fourier_w", (64, 3, 12), 0.5, 2.0), "nerf": (None, None, None, None)}
    for name, (key, shape, mean, std) in cases.items():
        _, te = _pair(name)
        a = te.init(64, torch.Generator().manual_seed(0))
        b = te.init(64, torch.Generator().manual_seed(0))
        if key is None:
            assert a == b == {}
            continue
        assert set(a) == {key} and tuple(a[key].shape) == shape and torch.equal(a[key], b[key])
        assert abs(float(a[key].mean()) - mean) < 0.05 * std
        assert abs(float(a[key].std()) - std) < 0.05 * std


def _field_kwargs(name, dim_out=4):
    cls, kw = ENCODINGS[name]
    return dict(encoding_type=f"neural_graph_mapping_tpu.ops.encodings.{cls}", encoding_kwargs=kw,
                num_layers=1, dim_out=dim_out)


def _set_kwargs(name, dim_points=3, dim_out=4, outside=1.0):
    field = _field_kwargs(name, dim_out)
    if dim_points == 2:
        field["encoding_kwargs"] = dict(field["encoding_kwargs"], dim_in=2)
    return dict(dim_points=dim_points, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
                field_kwargs=field, num_knn=2, distance_factor=10.0, outside_value=outside,
                field_radius=1.0, scale_mode="unit_ball")


@pytest.mark.parametrize("name", ["triplane-concat", "fourier-raw", "nerf"])
def test_field_set_apply_vmap_matches_jax(name):
    """Posed field-parallel evaluation through NeuralField.apply: 1e-5."""
    jfs, tfs = JaxFieldSet(**_set_kwargs(name)), NeuralFieldSet(**_set_kwargs(name))
    params = _set_params(jfs, 3, 4)
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    quat = rng.normal(size=(3, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pts = (pos[:, None] + rng.uniform(-1, 1, (3, 9, 3))).astype(np.float32)
    want = jfs.apply_vmap({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts),
                          jnp.asarray(pos), jnp.asarray(quat))
    got = tfs.apply_vmap(interop.params_from_jax(params, "cpu"), torch.from_numpy(pts),
                         torch.from_numpy(pos), torch.from_numpy(quat))
    assert_close(want, got, atol=1e-5)


def test_geometry_gradients_through_nerf():
    """Point gradients of the geometry channel through the NeRF octaves,
    against JAX's: within 1e-5 relative to their peak."""
    kw = _field_kwargs("nerf")
    kw["encoding_kwargs"] = dict(dim_in=3, num_octaves=4)
    jf, tf = JaxField(**kw), NeuralField(**kw)
    params = _seeded_like(jax.eval_shape(jf.init, jax.random.PRNGKey(3)), 3)
    pts = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (64, 3), minval=-0.4, maxval=0.4))
    want = np.asarray(jf.geometry_gradients({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts)))
    got = to_np(tf.geometry_gradients({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(pts)))
    assert got.shape == (64, 3) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _knn_inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, dim)) * 1.5).astype(np.float32)
    if dim == 2:
        theta = rng.uniform(0, 2 * np.pi, n)
        ori = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    else:
        ori = rng.normal(size=(n, 4)).astype(np.float32)
        ori /= np.linalg.norm(ori, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-1] = False
    pts = (rng.normal(size=(400, dim)) * 2.0).astype(np.float32)
    pts[:5] = 50.0  # outside every field
    return pos, ori, valid, pts


@pytest.mark.parametrize(
    "name,dim,capacity",
    [("fourier-raw", 2, 512), ("fourier-raw", 2, 16), ("triplane-sum", 3, 4)],
    ids=["fourier-2d", "fourier-2d-drops", "triplane-3d-drops"],
)
def test_apply_knn_matches_jax(name, dim, capacity):
    """The capacity route of 2D and 3D field sets with these encodings:
    outputs within 1e-5 and the same dropped-pair count as JAX."""
    jfs = JaxFieldSet(**_set_kwargs(name, dim, 3 if dim == 2 else 4, 0.0))
    tfs = NeuralFieldSet(**_set_kwargs(name, dim, 3 if dim == 2 else 4, 0.0))
    params = _set_params(jfs, 6, 5)
    pos, ori, valid, pts = _knn_inputs(6, dim, 6)
    want, want_dropped = jfs.apply_knn({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts),
                                       jnp.asarray(pos), jnp.asarray(ori), jnp.asarray(valid),
                                       capacity=capacity, with_stats=True)
    got, dropped = tfs.apply_knn(interop.params_from_jax(params, "cpu"), torch.from_numpy(pts),
                                 torch.from_numpy(pos), torch.from_numpy(ori), torch.from_numpy(valid),
                                 capacity=capacity, with_stats=True)
    assert int(dropped) == int(want_dropped)
    assert (int(dropped) > 0) == (capacity < 100)
    assert_close(want, got, atol=1e-5)
    np.testing.assert_array_equal(to_np(got)[:5], 0.0)  # outside_value


# -- a map built with one of these encodings --------------------------------------------


def _map_config(name):
    cfg = tiny_config(eval_num_samples=24, pixel_block_size=256)
    mk = dict(cfg["model_kwargs"], scale_mode="unit_ball")
    mk["field_kwargs"] = _field_kwargs(name)
    return {**cfg, "model_kwargs": mk}


@pytest.mark.parametrize("name", ["triplane-sum", "fourier-raw", "nerf"])
def test_map_refuses_to_train_but_renders_and_meshes(name):
    """process_frame allocates fields, then raises ValueError where it
    would train (JAX fails there too: training needs apply_fm_soa); the map
    still renders on the capacity route and meshes through apply_knn."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(_map_config(name), "cpu")
    assert not ngm._fset.supports_tiled_knn()
    with pytest.raises(ValueError, match="cannot train"):
        ngm.process_frame(ds, 0, ds[0]["rgbd"])
    assert ngm.num_fields > 0
    cam = ds.camera.scaled_camera(0.4)
    rgbd, dv = ngm.render_image(ds[0]["c2w"], cam)
    assert rgbd.shape == (12, 16, 4) and bool(torch.isfinite(rgbd).all() & torch.isfinite(dv).all())
    assert ngm.render_stats["route"] == "capacity" and ngm.render_stats["probe_max_count"] > 0
    from neural_graph_mapping_tpu_torch.mapping import meshing

    stats = {}
    meshing.extract_mesh(
        ngm._fset, ngm._params, ngm._map_arrays.positions, ngm._map_arrays.orientations,
        ngm._allocated_mask(), 1.0, "nrgbd", 20.0, resolution=0.5, eval_chunk=2048, knn_capacity=4096,
        stats=stats,
    )
    assert stats["blocks_evaluated"] > 0 and stats["dropped_pairs"] == 0


@pytest.mark.parametrize("name", ["triplane-concat", "fourier", "nerf"])
def test_interop_and_checkpoint_carry_the_encoding_leaves(name, tmp_path):
    """interop carries enc.planes / enc.fourier_w / no encoding leaf with
    their shapes checked; save_model writes them under the JAX npz keys
    and load_model restores them."""
    from neural_graph_mapping_tpu_torch import run_mapping

    jfs = JaxFieldSet(**_map_config(name)["model_kwargs"])
    params = _set_params(jfs, 4, 1)
    got = interop.params_from_jax(params, "cpu")
    assert set(got) == set(params) and all(k != "enc.table" for k in got)
    for k, v in params.items():
        if k.startswith("enc."):
            with pytest.raises(ValueError, match="expected"):
                interop.params_from_jax(dict(params, **{k: v.reshape(v.shape[0], -1)}), "cpu")

    cfg = dict(_map_config(name), out_dir=str(tmp_path), dataset_type=(
        "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset"), dataset_config=DS_CFG)
    runner = run_mapping.NeuralGraphMapRunner(cfg, device="cpu")
    e = runner.engine
    n = e.capacity
    e._params = interop.params_from_jax(
        _set_params(jfs, n, 2), "cpu")
    e._num_fields = 3
    path = runner.save_model(tmp_path / "m.npz")
    with np.load(path) as npz:
        keys = {k for k in npz.files if k.startswith("params.")}
    assert keys == {f"params.{k}" for k in params}
    fresh = run_mapping.NeuralGraphMapRunner(cfg, device="cpu")
    fresh.load_model(path)
    for k, v in e._params.items():
        assert torch.equal(fresh.engine._params[k], v), k
    assert fresh.engine.num_fields == 3
    other = "fourier" if name == "nerf" else "nerf"
    mismatched = run_mapping.NeuralGraphMapRunner(dict(cfg, model_kwargs=_map_config(other)["model_kwargs"]),
                                                  device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        mismatched.load_model(path)


def test_field_leftovers_match_jax():
    """NeuralField.apply_fm and numel, NeuralFieldSet.apply_vmap_fm (posed
    and local) and scatter_fields, on permutohedral fields, against JAX's:
    outputs within 1e-5, counts and scatters exact."""
    from test_torch_render import _fields

    jfs, tfs, params, positions, quats, _ = _fields(2)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, interop.params_from_jax(params, "cpu")
    rng = np.random.default_rng(3)
    pts = (positions[:, None] + rng.uniform(-0.8, 0.8, (len(positions), 30, 3))).astype(np.float32)
    want = jfs.apply_vmap_fm(jp, jnp.asarray(pts), jnp.asarray(positions), jnp.asarray(quats))
    got = tfs.apply_vmap_fm(tp, torch.from_numpy(pts), torch.from_numpy(positions), torch.from_numpy(quats))
    assert got.shape == (len(positions), 4, 30)
    assert_close(want, got, atol=1e-5)
    local = rng.uniform(-0.2, 1.2, pts.shape).astype(np.float32)
    assert_close(jfs.apply_vmap_fm(jp, jnp.asarray(local)), tfs.apply_vmap_fm(tp, torch.from_numpy(local)), atol=1e-5)
    one = {k: v[1] for k, v in tp.items()}
    assert_close(jfs.prototype.apply_fm({k: v[1] for k, v in jp.items()}, jnp.asarray(local[1])),
                 tfs.prototype.apply_fm(one, torch.from_numpy(local[1])), atol=1e-5)
    assert tfs.prototype.numel() == tfs.numel_per_field() == jfs.numel_per_field()
    ids = np.array([1, 3])
    sub = {k: v[ids] + 1.0 for k, v in params.items()}
    want = jfs.scatter_fields(jp, jnp.asarray(ids), {k: jnp.asarray(v) for k, v in sub.items()})
    got = tfs.scatter_fields(tp, torch.from_numpy(ids), to_torch(sub))
    for k in params:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert torch.equal(tp["w0"], torch.from_numpy(params["w0"]))  # the input is left alone


# -- L0 helpers --------------------------------------------------------------------------


def test_l0_helpers_match_jax():
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(5, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.0, 5).astype(np.float32)
    for r in (radii, np.float32(0.5)):
        want = jgeometry.spheres_to_aabbs(jnp.asarray(centers), jnp.asarray(r))
        got = geometry.spheres_to_aabbs(torch.from_numpy(centers), torch.as_tensor(r))
        for w, g in zip(want, got):
            assert_close(w, g, atol=0)
    mins, maxs = geometry.spheres_to_aabbs(torch.from_numpy(centers), torch.from_numpy(radii))
    bmin = rng.normal(size=(2, 4, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 1.5, (2, 4, 3)).astype(np.float32)
    want = jgeometry.aabbs_intersect(jnp.asarray(to_np(mins)), jnp.asarray(to_np(maxs)),
                                     jnp.asarray(bmin), jnp.asarray(bmax))
    got = geometry.aabbs_intersect(mins, maxs, torch.from_numpy(bmin), torch.from_numpy(bmax))
    assert got.shape == (2, 4, 5)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()

    ends = rng.normal(size=(40, 3)).astype(np.float32) * 3
    want = jgeometry.rays_intersect_spheres(jnp.zeros((1, 3)), jnp.asarray(ends), jnp.asarray(centers), 0.8)
    got = geometry.rays_intersect_spheres(torch.zeros((1, 3)), torch.from_numpy(ends), torch.from_numpy(centers), 0.8)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))

    jc = jcamera.Camera.create(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    tc = camera.Camera.create(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    ijs = rng.uniform(0, 48, (7, 2)).astype(np.float32)
    dist = rng.uniform(0.5, 4.0, 7).astype(np.float32)
    assert_close(jc.distance_to_depth(jnp.asarray(dist), jnp.asarray(ijs)),
                 tc.distance_to_depth(torch.from_numpy(dist), torch.from_numpy(ijs)), atol=1e-6)
    full = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    back = tc.depth_to_distance(tc.distance_to_depth(torch.from_numpy(full)))
    assert_close(jc.distance_to_depth(jnp.asarray(full)), tc.distance_to_depth(torch.from_numpy(full)), atol=1e-6)
    assert_close(full, back, atol=1e-5)

    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m = transforms.quaternion_to_matrix(torch.from_numpy(q))
    assert_close(jtransforms.quaternion_to_matrix(jnp.asarray(q)), m, atol=1e-6)
    assert_close(transforms.matrix_to_quaternion(m).abs(), np.abs(q), atol=1e-5)
    x = rng.normal(size=(3, 5, 3)).astype(np.float32)
    h = transforms.to_homogeneous(torch.from_numpy(x))
    assert_close(jtransforms.to_homogeneous(jnp.asarray(x)), h, atol=0)
    for norm in (False, True):
        assert_close(jtransforms.to_inhomogeneous(jnp.asarray(2 * x), normalize=norm),
                     transforms.to_inhomogeneous(torch.from_numpy(2 * x), normalize=norm), atol=1e-7)
