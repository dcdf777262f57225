"""The port's full-image render path against the JAX package on the CPU:
``NeuralFieldSet.apply_knn_tiled``, ``span_sample_distances``, the
channels-last ``quadrature``, one render block (``render_block_tiled``) on
both encode routes, the render metrics, and ``NeuralGraphMap.render_image``
on a map trained for a few frames. The port runs its kernels' plain
versions here; JAX runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np
from test_torch_engine import DS_CFG, tiny_config

from neural_graph_mapping_tpu import camera as jcamera
from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.eval import render_metrics as jmetrics
from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping.render import RenderConfig as JaxRenderConfig
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu.ops import quadrature as jquad
from neural_graph_mapping_tpu_torch import camera, interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.eval import render_metrics
from neural_graph_mapping_tpu_torch.mapping import engine, render
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import permuto_cuda, quadrature

N = 5


def _fset_kwargs(num_knn=2):
    return dict(
        dim_points=3,
        field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=dict(
            encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
            encoding_kwargs=dict(pos_dim=3, log2_hashmap_size=7, nr_levels=3, nr_feat_per_level=2,
                                 coarsest_scale=1.0, finest_scale=0.05, init_scale=1e-2),
            num_layers=1, dim_out=4,
        ),
        num_knn=num_knn, distance_factor=10.0, outside_value=1.0, field_radius=1.0,
        scale_mode="unit_cube",
    )


def _fields(seed, num_knn=2, skewed=False):
    """Random stacked params (tables U(-1, 1), so the encode matters),
    rotated poses, one invalid slot."""
    jfs = JaxFieldSet(**_fset_kwargs(num_knn))
    params = {k: np.asarray(v) for k, v in jfs.init_fields(jax.random.PRNGKey(seed), N).items()}
    rng = np.random.default_rng(seed)
    params["enc.table"] = rng.uniform(-1, 1, params["enc.table"].shape).astype(np.float32)
    if skewed:  # one dominant field near the origin, the others far away
        positions = np.array([[0.0, 0, 0], [5, 0, 0], [0, 5, 0], [0, 0, 5], [3, 3, 3]], np.float32)
    else:
        positions = (rng.normal(size=(N, 3)) * 1.5).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    valid = np.array([True, True, True, True, False])
    return jfs, NeuralFieldSet(**_fset_kwargs(num_knn)), params, positions, quats, valid


def _points(seed, skewed=False, n=300):
    rng = np.random.default_rng(100 + seed)
    scale = 0.3 if skewed else 2.0
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    pts[:10] = [40.0, 0.0, 0.0]  # outside every field
    return pts


def _both_knn(jfs, tfs, params, positions, quats, valid, pts):
    j = (jnp.asarray(pts), jnp.asarray(positions), jnp.asarray(quats), jnp.asarray(valid))
    t = (torch.from_numpy(pts), torch.from_numpy(positions), torch.from_numpy(quats), torch.from_numpy(valid))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    got = tfs.apply_knn_tiled(interop.params_from_jax(params, "cpu"), *t)
    return jp, j, to_np(got)


@pytest.mark.parametrize(
    "num_knn,skewed", [(2, False), (3, False), (2, True)], ids=["k2", "k3", "k2-skewed"]
)
def test_apply_knn_tiled_matches_jax_capacity_path(num_knn, skewed):
    """Against JAX's f32 capacity path with capacity ample enough to drop
    nothing: within 1e-5 (both f32; the port's k = 2 distances come from
    (p - c)^2, JAX's from |p|^2 + |c|^2 - 2 p.c)."""
    jfs, tfs, params, positions, quats, valid = _fields(0, num_knn, skewed)
    pts = _points(0, skewed)
    jp, j, got = _both_knn(jfs, tfs, params, positions, quats, valid, pts)
    want, dropped = jfs.apply_knn(jp, *j, capacity=4096, with_stats=True)
    assert int(dropped) == 0
    assert got.shape == (pts.shape[0], 4)
    assert_close(want, got, atol=1e-5)
    np.testing.assert_array_equal(got[:10], 1.0)  # outside_value
    assert np.isfinite(got).all()


@pytest.mark.parametrize("num_knn", [2, 3], ids=["k2-kmajor", "k3-kminor"])
def test_apply_knn_tiled_matches_jax_tiled_path(num_knn):
    """Against JAX's own tiled path in interpret mode, at the tolerance the
    JAX package holds it to against its capacity path (atol 2e-4, rtol
    1e-3): JAX's MoE encode reads bf16 tables."""
    jfs, tfs, params, positions, quats, valid = _fields(1, num_knn)
    pts = _points(1)
    jp, j, got = _both_knn(jfs, tfs, params, positions, quats, valid, pts)
    want = jfs.apply_knn_tiled(jp, *j, interpret=True)
    assert_close(want, got, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("spacing", [0.0, 0.0125])
def test_span_sample_distances_match_jax(spacing):
    rng = np.random.default_rng(5)
    t0 = rng.uniform(0.0, 3.0, 50).astype(np.float32)
    t1 = (t0 + rng.uniform(0.0, 2.0, 50)).astype(np.float32)
    u = rng.random((50, 32)).astype(np.float32)
    want = jengine.span_sample_distances(jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(u), spacing)
    got = engine.span_sample_distances(torch.from_numpy(t0), torch.from_numpy(t1), torch.from_numpy(u), spacing)
    assert_close(want, got, atol=1e-6)


@pytest.mark.parametrize("mode", ["density", "occupancy", "neus", "nrgbd"])
def test_quadrature_channels_last_matches_jax(mode):
    """All five results and the sample weights within 1e-6 (f32)."""
    rng = np.random.default_rng(6)
    colors = rng.random((7, 40, 3)).astype(np.float32)
    geoms = rng.normal(size=(7, 40)).astype(np.float32) * 0.3
    dists = np.sort(rng.uniform(0.5, 4.0, (7, 40)), axis=-1).astype(np.float32)
    depths = (dists * 0.9).astype(np.float32)
    isds = np.float32(2.0) if mode == "neus" else None
    want = jquad.quadrature(mode, *(jnp.asarray(a) for a in (colors, geoms, dists, depths)),
                            geometry_factor=20.0, neus_isds=isds)
    got = quadrature.quadrature(mode, *(torch.from_numpy(a) for a in (colors, geoms, dists, depths)),
                                geometry_factor=20.0,
                                neus_isds=None if isds is None else torch.tensor(isds))
    for name in want._fields:
        assert_close(getattr(want, name), getattr(got, name), atol=1e-6, err_msg=name)


# -- one render block -----------------------------------------------------------

OFFSET, B, S = 64, 64, 32  # k * S = 64: a power of two, so the ray route applies
SPACING = 2 * 0.1 / 16  # the production eval spacing


def _block_setup(seed=0):
    jfs, tfs, params, positions, quats, valid = _fields(seed)
    jcam = jcamera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    tcam = camera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    jrc = JaxRenderConfig(geometry_mode="nrgbd", geometry_factor=20.0, color_factor=1.0)
    trc = render.RenderConfig(**jrc._asdict())
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    ii, jj = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    ijs = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float32)[OFFSET:OFFSET + B]
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (B, S)))  # the draw render_block_tiled_jit makes
    return dict(jfs=jfs, tfs=tfs, params=params, positions=positions, quats=quats, valid=valid,
                jcam=jcam, tcam=tcam, jrc=jrc, trc=trc, c2w=c2w, ijs=ijs, key=key, u=u)


def _jax_block(st, fset, **kw):
    return jengine.render_block_tiled_jit(
        fset, st["jcam"], st["jrc"], S, 0.1, 8.0, {k: jnp.asarray(v) for k, v in st["params"].items()},
        jnp.asarray(st["positions"]), jnp.asarray(st["quats"]), jnp.asarray(st["valid"]),
        jnp.asarray(st["ijs"]), jnp.asarray(st["c2w"]), st["key"], sample_spacing=SPACING, **kw,
    )


def _port_block(st, use_ray_kernel):
    return engine.render_block_tiled(
        st["tfs"], st["tcam"], st["trc"], S, 0.1, 8.0, interop.params_from_jax(st["params"], "cpu"),
        torch.from_numpy(st["positions"]), torch.from_numpy(st["quats"]),
        torch.from_numpy(st["valid"]), torch.from_numpy(st["ijs"]), torch.from_numpy(st["c2w"]),
        u=torch.from_numpy(st["u"]), use_ray_kernel=use_ray_kernel, block_offset=OFFSET,
        sample_spacing=SPACING,
    )


@pytest.mark.parametrize("use_ray_kernel", [True, False], ids=["rays", "carried"])
def test_render_block_matches_jax_tiled(use_ray_kernel):
    """Against render_block_tiled_jit(interpret=True) with the same jitter:
    within 8e-3, the bf16 tolerance of the JAX package's own test of its
    packed outputs, because the JAX block reads its tables as bf16 and packs
    its outputs as bf16 pairs (the port stays in f32)."""
    st = _block_setup()
    want = _jax_block(st, st["jfs"], interpret=True, use_ray_kernel=use_ray_kernel,
                      block_offset=jnp.asarray(OFFSET, jnp.int32))
    got = _port_block(st, use_ray_kernel)
    for w, g in zip(want, got):
        assert_close(w, g, atol=8e-3)
    assert got[0].shape == (B, 4) and np.isfinite(to_np(got[0])).all()


class _CapacityFieldSet(JaxFieldSet):
    """JAX field set whose tiled path is its f32 capacity path at ample
    capacity: render_block_tiled_jit then composes JAX's span code,
    span_sample_distances, apply_knn and quadrature, all in f32."""

    def apply_knn_tiled(self, stacked_params, query_points, field_positions, field_orientations,
                        field_valid, **_):
        return self.apply_knn(stacked_params, query_points, field_positions, field_orientations,
                              field_valid, capacity=4 * query_points.shape[0])


@pytest.mark.parametrize("use_ray_kernel", [True, False], ids=["rays", "carried"])
def test_render_block_matches_jax_f32_composition(use_ray_kernel):
    """Against the same block composed in f32 by JAX: rgbd and depth
    variance within 2e-5 (the ray route rebuilds points with other
    arithmetic than world = origin + dir * distance)."""
    st = _block_setup()
    want = _jax_block(st, _CapacityFieldSet(**_fset_kwargs()))
    got = _port_block(st, use_ray_kernel)
    assert_close(want[0], got[0], atol=2e-5)
    assert_close(want[1], got[1], atol=2e-5)
    assert_close(want[2], got[2], atol=2e-5)


# -- metrics ------------------------------------------------------------------------


def test_render_metrics_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(-0.1, 1.1, (30, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    da = rng.uniform(0.5, 4.0, (30, 40)).astype(np.float32)
    db = da + rng.normal(size=da.shape).astype(np.float32) * 0.1
    db[:5] = 0.0  # no target depth: not counted
    for crop in (None, 0, 3):
        assert render_metrics.psnr(torch.from_numpy(a), torch.from_numpy(b), crop) == pytest.approx(
            jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), crop), abs=1e-4)
        assert render_metrics.ssim(torch.from_numpy(a), torch.from_numpy(b), crop) == pytest.approx(
            jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), crop), abs=1e-5)
        assert render_metrics.depthl1(torch.from_numpy(da), torch.from_numpy(db), crop) == pytest.approx(
            jmetrics.depthl1(jnp.asarray(da), jnp.asarray(db), crop), abs=1e-6)


# -- NeuralGraphMap.render_image ------------------------------------------------------


@pytest.fixture(scope="module")
def trained_map():
    """A map trained for three frames at a tiny config (40x30 frames)."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(tiny_config(eval_span_samples=32, pixel_block_size=512), "cpu")
    for fid in range(3):
        ngm.process_frame(ds, fid, ds[fid]["rgbd"])
    assert ngm.num_fields > 0
    return ngm, ds


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(permuto_cuda, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    monkeypatch.setattr(permuto_cuda, name, spy)
    return calls


def test_render_image_equals_its_blocks(trained_map, monkeypatch):
    """render_image at k * S = 64 (ray route): shapes, finite values, one
    ray-kernel call per block, and equality with render_block_tiled over
    the same blocks and the same generator draws."""
    ngm, ds = trained_map
    rays = _count_calls(monkeypatch, "encode_fwd_moe_rays")
    carried = _count_calls(monkeypatch, "encode_fwd_moe")
    c2w = ds[2]["c2w"]
    state = ngm._init_gen.get_state()
    rgbd, dv = ngm.render_image(c2w, ds.camera)
    h, w = DS_CFG["height"], DS_CFG["width"]
    assert rgbd.shape == (h, w, 4) and dv.shape == (h, w)
    assert torch.isfinite(rgbd).all() and torch.isfinite(dv).all()
    n_blocks = -(-h * w // 512)
    assert len(rays) == n_blocks and not carried

    ngm._init_gen.set_state(state)
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ijs = torch.stack([ii, jj], -1).reshape(-1, 2).float()
    ijs = torch.cat([ijs, ijs.new_zeros((n_blocks * 512 - h * w, 2))])
    parts = [
        engine.render_block_tiled(
            ngm._fset, ds.camera, ngm._rcfg, 32, ngm._eval_near, ngm._eval_far, ngm._params,
            ngm._map_arrays.positions, ngm._map_arrays.orientations, ngm._allocated_mask(),
            ijs[s : s + 512], torch.as_tensor(c2w), generator=ngm._init_gen,
            use_ray_kernel=True, block_offset=s, sample_spacing=ngm._sample_spacing,
        )[0]
        for s in range(0, n_blocks * 512, 512)
    ]
    torch.testing.assert_close(rgbd.reshape(-1, 4), torch.cat(parts)[: h * w], rtol=0, atol=0)
    # expected depth of a ray lies between the camera and the far plane
    assert float(rgbd[..., 3].min()) >= 0.0 and float(rgbd[..., 3].max()) <= ngm._eval_far


def test_render_image_carried_route(trained_map, monkeypatch):
    """k * S = 48 is not a power of two: every block takes encode_fwd_moe."""
    ngm, ds = trained_map
    rays = _count_calls(monkeypatch, "encode_fwd_moe_rays")
    carried = _count_calls(monkeypatch, "encode_fwd_moe")
    monkeypatch.setattr(ngm, "_eval_span_samples", 24)
    rgbd, _ = ngm.render_image(ds[1]["c2w"], ds.camera)
    assert torch.isfinite(rgbd).all()
    assert len(carried) == 3 and not rays


@pytest.mark.parametrize("span,block,ray_route", [(512, 8192, True), (768, 5461, False)])
def test_render_routes_and_block_shrink(trained_map, monkeypatch, span, block, ray_route):
    """k * S = 1024 takes the ray route; 1536 the carried route, and a span
    above 512 samples shrinks the ray block in proportion (8192 * 512 / 768)."""
    ngm, ds = trained_map
    monkeypatch.setattr(ngm, "_eval_span_samples", span)
    monkeypatch.setattr(ngm, "_pixel_block_size", 8192)
    seen = []

    def stub(fset, cam, rcfg, num_samples, *args, use_ray_kernel=False, **kwargs):
        ijs = args[6]
        seen.append((num_samples, ijs.shape[0], use_ray_kernel))
        zeros = ijs.new_zeros(ijs.shape[0])
        return ijs.new_zeros((ijs.shape[0], 4)), zeros, zeros

    monkeypatch.setattr(engine, "render_block_tiled", stub)
    assert ngm.render_block_size() == block
    rgbd, _ = ngm.render_image(ds[0]["c2w"], ds.camera)
    assert rgbd.shape == (DS_CFG["height"], DS_CFG["width"], 4)
    assert seen == [(span, block, ray_route)]


def test_render_image_raises_off_the_tiled_path(trained_map, monkeypatch):
    """An explicit ``capacity_per_field`` takes the capacity-buffer route
    and renders; nothing here raises any more. The name is the one this
    test had while that route raised, kept so that its history and its
    count carry over. A 16x12 image of the trained
    map, whose 1,024 slots a field drop pairs, within 1e-4 of JAX's CPU
    render_image on the same weights, with JAX's per-block jitter (its
    _next_key() stream) replayed into the port's render_block."""
    ngm, ds = trained_map
    jngm = jengine.NeuralGraphMap(tiny_config(eval_span_samples=32, pixel_block_size=512))
    jngm._params = {k: jnp.asarray(to_np(v)) for k, v in ngm._params.items()}
    m = ngm._map_arrays
    jngm._map_arrays = jngm._map_arrays._replace(**{k: jnp.asarray(to_np(getattr(m, k))) for k in m._fields})
    jngm._num_fields = ngm.num_fields
    cam = ds.camera.scaled_camera(0.4)
    jcam = JaxSynthetic(DS_CFG).camera.scaled_camera(0.4)
    assert jcam.__dict__ == cam.__dict__
    _, sub = jax.random.split(jngm._key)  # one block: the key render_image will take
    u = torch.from_numpy(np.array(jax.random.uniform(sub, (512, ngm._eval_num_samples))))
    want_rgbd, want_dv = jngm.render_image(jnp.asarray(ds[1]["c2w"]), jcam, capacity_per_field=1024)
    orig = engine.render_block
    monkeypatch.setattr(engine, "render_block", lambda *a, **kw: orig(*a, **dict(kw, u=u)))
    rgbd, dv = ngm.render_image(ds[1]["c2w"], cam, capacity_per_field=1024)
    assert ngm.render_stats["route"] == "capacity" and ngm.render_stats["dropped_pairs"] > 0
    assert_close(want_rgbd, rgbd, atol=1e-4)
    assert_close(want_dv, dv, atol=1e-4)


def test_render_config_keys():
    """The eval keys as the JAX engine reads them (spacing 2 * 0.1 / 16 at
    the production config; span min(512, derived count))."""
    cfg = tiny_config(num_samples_depth_guided=16, eval_span_samples=600)
    ngm = engine.NeuralGraphMap(cfg, "cpu")
    jngm = jengine.NeuralGraphMap(cfg)
    for name in ("_eval_near", "_eval_far", "_sample_spacing", "_eval_num_samples",
                 "_eval_span_samples", "_pixel_block_size"):
        assert getattr(ngm, name) == getattr(jngm, name), name
    assert ngm._sample_spacing == pytest.approx(0.0125)
    assert ngm.render_block_size() == max(1024, int(8192 * 512 / 600))


def test_scaled_camera_matches_jax():
    jc = jcamera.Camera.create(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)
    tc = camera.Camera.create(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)
    for f in (0.5, 4.0):
        assert tc.scaled_camera(f).__dict__ == jc.scaled_camera(f).__dict__
