"""The port's capacity-buffer KNN route against the JAX package on the CPU:
``dispatch.dispatch_indices`` / ``expert_eval``, ``NeuralFieldSet.apply_knn``
with and without dropped pairs, ``engine.render_demand_probe``,
``engine.render_block`` against ``render_block_jit`` on replayed jitter,
``render_image`` of a map the tiled route cannot take (concatenated
points) against JAX's CPU render block for block, and that map's meshing
through ``apply_knn``. JAX's capacity route is XLA only."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np
from test_torch_engine import DS_CFG, tiny_config
from test_torch_render import _fields, _fset_kwargs, _points

from neural_graph_mapping_tpu import camera as jcamera
from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping import meshing as jmeshing
from neural_graph_mapping_tpu.mapping.render import RenderConfig as JaxRenderConfig
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu.ops import dispatch as jdispatch
from neural_graph_mapping_tpu_torch import camera, interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine, meshing, render
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import dispatch
from neural_graph_mapping_tpu_torch.utils import chunking


@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_dispatch_indices_match_jax(capacity):
    """Slots, kept and counts exactly, with invalid pairs and pairs past
    capacity (slot N * C)."""
    rng = np.random.default_rng(capacity)
    ids = rng.integers(0, 5, 200).astype(np.int32)
    valid = rng.random(200) > 0.2
    want = jdispatch.dispatch_indices(jnp.asarray(ids), jnp.asarray(valid), 5, capacity)
    got = dispatch.dispatch_indices(torch.from_numpy(ids), torch.from_numpy(valid), 5, capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    kept = to_np(got[1])
    assert (to_np(got[0])[~kept] == 5 * capacity).all() and (~kept & valid).any() == (capacity < 64)


def test_expert_eval_matches_jax(monkeypatch):
    """Per-expert affine maps through the (N, C) buffer, in slices of one
    and of several experts: equal to JAX's, zeros for dropped pairs."""
    rng = np.random.default_rng(2)
    scale = rng.normal(size=(6, 3)).astype(np.float32)
    shift = rng.normal(size=(6, 3)).astype(np.float32)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    ids = rng.integers(0, 6, 300).astype(np.int32)
    valid = rng.random(300) > 0.1
    want, want_kept = jdispatch.expert_eval(
        lambda p, x: x * p["s"] + p["b"], {"s": jnp.asarray(scale), "b": jnp.asarray(shift)},
        jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(valid), 6, 40, 3,
    )
    assert not bool(want_kept.all())
    for slice_points in (40, 100, 1 << 20):
        monkeypatch.setattr(dispatch, "EXPERT_SLICE_POINTS", slice_points)
        got, kept = dispatch.expert_eval(
            lambda p, x: x * p["s"][:, None, :] + p["b"][:, None, :],
            {"s": torch.from_numpy(scale), "b": torch.from_numpy(shift)}, torch.from_numpy(pts),
            torch.from_numpy(ids), torch.from_numpy(valid), 6, 40, 3,
        )
        np.testing.assert_array_equal(to_np(kept), np.asarray(want_kept))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize(
    "num_knn,capacity,override",
    [(2, 4096, {}), (2, 20, {}), (3, 32, {}), (2, 64, {"field_radius": 1.5, "num_knn": 1})],
    ids=["k2", "k2-drops", "k3-drops", "overrides"],
)
def test_apply_knn_matches_jax(num_knn, capacity, override):
    """Blended outputs within 1e-5 and the dropped-pair count equal to
    JAX's, on random permutohedral fields (rotated poses, an invalid slot,
    points outside every field; one dominant field takes most points)."""
    jfs, tfs, params, positions, quats, valid = _fields(3, num_knn, skewed=True)
    pts = _points(3, skewed=True)
    j = (jnp.asarray(pts), jnp.asarray(positions), jnp.asarray(quats), jnp.asarray(valid))
    want, want_dropped = jfs.apply_knn({k: jnp.asarray(v) for k, v in params.items()}, *j,
                                       capacity=capacity, with_stats=True, **override)
    got, dropped = tfs.apply_knn(
        interop.params_from_jax(params, "cpu"), torch.from_numpy(pts), torch.from_numpy(positions),
        torch.from_numpy(quats), torch.from_numpy(valid), capacity=capacity, with_stats=True, **override,
    )
    assert int(dropped) == int(want_dropped)
    assert (int(dropped) > 0) == (capacity < 100)
    assert_close(want, got, atol=1e-5)
    np.testing.assert_array_equal(to_np(got)[:10], 1.0)  # outside_value


def _block_inputs(seed=0, neus=False):
    jfs, tfs, params, positions, quats, valid = _fields(seed)
    if neus:
        params["neus_sd"] = np.random.default_rng(seed).uniform(0.5, 1.5, (len(valid),)).astype(np.float32)
    jcam = jcamera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    tcam = camera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    jrc = JaxRenderConfig(geometry_mode="neus" if neus else "nrgbd", geometry_factor=20.0, color_factor=1.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    ii, jj = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    ijs = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float32)[40:104]
    return jfs, tfs, params, positions, quats, valid, jcam, tcam, jrc, c2w, ijs


@pytest.mark.parametrize("neus,capacity", [(False, 4096), (False, 256), (True, 4096)],
                         ids=["nrgbd", "nrgbd-drops", "neus"])
def test_render_block_matches_jax(neus, capacity):
    """render_block against render_block_jit with the jitter JAX draws from
    its key: the same dropped pairs; colour and termination within 1e-5;
    depth (m) and depth variance (m^2) within 3e-5. The blended field
    values at the block's samples agree to ~6e-8, and on a ray whose
    surface bell is steep (geometry factor 20 over 0.16 m samples) the
    compositing carries that to ~3e-5 in the depth moments."""
    jfs, tfs, params, positions, quats, valid, jcam, tcam, jrc, c2w, ijs = _block_inputs(4, neus)
    key, s = jax.random.PRNGKey(11), 48
    want = jengine.render_block_jit(
        jfs, jcam, jrc, s, 0.1, 8.0, capacity, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(positions), jnp.asarray(quats), jnp.asarray(valid), jnp.asarray(ijs), jnp.asarray(c2w), key,
    )
    u = torch.from_numpy(np.array(jax.random.uniform(key, (ijs.shape[0], s))))
    got = engine.render_block(
        tfs, tcam, render.RenderConfig(**jrc._asdict()), s, 0.1, 8.0, capacity,
        interop.params_from_jax(params, "cpu"), torch.from_numpy(positions), torch.from_numpy(quats),
        torch.from_numpy(valid), torch.from_numpy(ijs), torch.from_numpy(c2w), u=u,
    )
    assert_close(np.asarray(want[0])[:, :3], got[0][:, :3], atol=1e-5)
    assert_close(np.asarray(want[0])[:, 3], got[0][:, 3], atol=3e-5)
    assert_close(want[1], got[1], atol=3e-5)
    assert_close(want[2], got[2], atol=1e-5)
    assert int(got[3]) == int(want[3])
    assert (int(got[3]) > 0) == (capacity < 1000)
    assert got[0].shape == (64, 4) and float(got[2].max()) > 0.5  # some rays hit a surface


def test_render_demand_probe_matches_jax():
    jfs, tfs, params, positions, quats, valid, jcam, tcam, _, c2w, ijs = _block_inputs(5)
    want = jengine.render_demand_probe(
        jfs, jcam, 64, 0.1, 8.0, {}, jnp.asarray(positions), jnp.asarray(valid), jnp.asarray(ijs),
        jnp.asarray(c2w),
    )
    got = engine.render_demand_probe(
        tfs, tcam, 64, 0.1, 8.0, torch.from_numpy(positions), torch.from_numpy(valid),
        torch.from_numpy(ijs), torch.from_numpy(c2w),
    )
    assert int(got) == int(want) > 0


def test_warn_dropped_pairs(caplog):
    log = logging.getLogger("capacity-test")
    with caplog.at_level(logging.WARNING, logger="capacity-test"):
        assert chunking.warn_dropped_pairs([torch.tensor(0), 0], log, "render", 8) == 0
        assert not caplog.records
        assert chunking.warn_dropped_pairs([torch.tensor(3), 4], log, "meshing", 8) == 7
    assert "meshing capacity path DROPPED 7" in caplog.records[0].getMessage()


# -- a map the tiled route cannot take: concatenated points --------------------------------


def _concat_config():
    cfg = tiny_config(eval_num_samples=24, pixel_block_size=128)
    mk = dict(cfg["model_kwargs"])
    fk = dict(mk["field_kwargs"])
    fk["encoding_kwargs"] = dict(fk["encoding_kwargs"], concat_points=True)
    mk["field_kwargs"] = fk
    return {**cfg, "model_kwargs": mk}


@pytest.fixture(scope="module")
def concat_maps():
    """A concat_points map with weights in JAX's layout and at its init's
    scales (seeded: linears U(+-1/sqrt(fan-in)), tables U(+-0.2) so the
    encoding shows) carried into both packages; fields allocated by the
    port's first frame."""
    cfg = _concat_config()
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(cfg, "cpu")
    ngm.process_frame(ds, 0, ds[0]["rgbd"])
    assert not ngm._fset.supports_tiled_knn() and ngm.num_fields > 8
    jngm = jengine.NeuralGraphMap(cfg)
    cap = ngm.capacity
    shapes = jax.eval_shape(lambda k: jngm._fset.init_fields(k, cap), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    bound = {k: 0.2 if k == "enc.table" else 1.0 / np.sqrt(shapes[f"w{k[1:]}"].shape[1]) for k in shapes}
    params = {k: rng.uniform(-bound[k], bound[k], v.shape).astype(np.float32) for k, v in shapes.items()}
    ngm._params = interop.params_from_jax(params, "cpu")
    m = ngm._map_arrays
    jngm._params = {k: jnp.asarray(v) for k, v in params.items()}
    jngm._map_arrays = jngm._map_arrays._replace(**{k: jnp.asarray(to_np(getattr(m, k))) for k in m._fields})
    jngm._num_fields = ngm.num_fields
    return cfg, ds, ngm, jngm, params


def test_concat_points_render_matches_jax_block_for_block(concat_maps, monkeypatch):
    """render_image of a 16x12 image: the demand probe sizes the buffer as
    JAX's does, and with JAX's per-block jitter (its _next_key() stream
    replayed into render_block) the image is within 1e-4 of JAX's CPU
    render_image."""
    _, ds, ngm, jngm, _ = concat_maps
    jcam = jcamera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    cam = camera.Camera.create(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    c2w = ds[0]["c2w"]
    block, s = ngm.render_block_size(), ngm._eval_num_samples
    n_blocks = -(-cam.height * cam.width // block)
    key = jngm._key
    jitter = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        jitter.append(torch.from_numpy(np.array(jax.random.uniform(sub, (block, s)))))
    want_rgbd, want_dv = jngm.render_image(jnp.asarray(c2w), jcam)
    orig = engine.render_block

    def replay(*args, **kwargs):
        kwargs["u"] = jitter.pop(0)
        return orig(*args, **kwargs)

    monkeypatch.setattr(engine, "render_block", replay)
    rgbd, dv = ngm.render_image(c2w, cam)
    assert not jitter and n_blocks == 2
    stats = ngm.render_stats
    assert stats["route"] == "capacity" and stats["probe_max_count"] > 0
    assert stats["capacity_per_field"] == 1 << max(13, int(np.ceil(np.log2(stats["probe_max_count"] * 1.5))))
    assert_close(want_rgbd, rgbd, atol=1e-4)
    assert_close(want_dv, dv, atol=1e-4)
    assert float(rgbd[..., 3].max()) > 0


def test_capacity_halves_to_the_buffer_cap(concat_maps, monkeypatch):
    """A demand that would need more than 2^25 slots in all halves the
    capacity down to that cap (not below 8192), as JAX sizes it."""
    _, ds, ngm, _, _ = concat_maps
    seen = []
    monkeypatch.setattr(engine, "render_demand_probe", lambda *a, **k: torch.tensor(10_000_000))

    def stub(self, ijs, c2w, camera, capacity):
        seen.append(capacity)
        z = ijs.new_zeros(ijs.shape[0])
        return ijs.new_zeros((ijs.shape[0], 4)), z, z, torch.tensor(0)

    monkeypatch.setattr(engine.NeuralGraphMap, "_render_ij_block", stub)
    ngm.render_image(ds[0]["c2w"], ds.camera.scaled_camera(0.2))
    assert seen and set(seen) == {max(8192, (1 << 25) // ngm.capacity)}


def test_render_image_with_capacity_draws_from_the_init_stream(concat_maps):
    """The capacity route's jitter comes from the init stream, as the tiled
    route's: the frame programs' generator is left alone."""
    _, ds, ngm, _, _ = concat_maps
    frame_state, init_state = ngm._frame_gen.get_state(), ngm._init_gen.get_state()
    ngm.render_image(ds[1]["c2w"], ds.camera.scaled_camera(0.2), capacity_per_field=8192)
    assert torch.equal(ngm._frame_gen.get_state(), frame_state)
    assert not torch.equal(ngm._init_gen.get_state(), init_state)
    assert ngm.render_stats == {"route": "capacity", "capacity_per_field": 8192, "probe_max_count": None,
                                "dropped_pairs": 0}


class CountingJaxFieldSet:
    """The JAX field set with every capacity-route call's drop count kept."""

    def __init__(self, fset):
        self.fset = fset
        self.dropped = []

    def apply_knn(self, *args, with_stats=False, **kwargs):
        out, dropped = self.fset.apply_knn(*args, with_stats=True, **kwargs)
        self.dropped.append(int(dropped))
        return (out, dropped) if with_stats else out


@pytest.mark.parametrize("jitter", [0.0, 1e-3], ids=["as-allocated", "moved-1mm"])
def test_concat_points_mesh_matches_jax(concat_maps, monkeypatch, jitter):
    """extract_mesh of the concat_points map takes apply_knn in both
    packages (a capacity that drops pairs): the same dropped pairs, and
    every block's volume within 1e-5 of JAX's. As allocated, fields sit on
    a lattice, so a grid point may lie equally far (to rounding) from its
    second and third field; both packages take the expanded distance form,
    but a point off by more than 1e-5 must be such a tie (as
    tests/test_torch_meshing.py holds the tiled route). Moved by ~1 mm,
    no point may be off."""
    cfg, _, ngm, _, params = concat_maps
    m = ngm._map_arrays
    positions = to_np(m.positions) + np.random.default_rng(5).normal(0.0, jitter, (ngm.capacity, 3)).astype(np.float32)
    orientations, valid = to_np(m.orientations), to_np(ngm._allocated_mask())
    kw = dict(field_radius=1.0, geometry_mode="nrgbd", geometry_factor=20.0, resolution=0.4, block_size=10,
              eval_chunk=1024, knn_capacity=384)
    volumes = {"jax": [], "port": []}
    for name, module in (("jax", jmeshing), ("port", meshing)):
        orig = module.native.marching_tetrahedra

        def record(vol, iso, orig=orig, name=name):
            volumes[name].append(np.array(vol))
            return orig(vol, iso)

        monkeypatch.setattr(module.native, "marching_tetrahedra", record)
    jfs = CountingJaxFieldSet(JaxFieldSet(**cfg["model_kwargs"]))
    jmeshing.extract_mesh(jfs, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(positions),
                          jnp.asarray(orientations), jnp.asarray(valid), **kw)
    stats = {}
    meshing.extract_mesh(ngm._fset, ngm._params, torch.from_numpy(positions), torch.from_numpy(orientations),
                         torch.from_numpy(valid), stats=stats, **kw)
    assert stats["dropped_pairs"] == sum(jfs.dropped) > 0
    assert len(volumes["port"]) == len(volumes["jax"]) == stats["blocks_evaluated"] > 1
    active = positions[valid]
    blocks = [b for b in meshing.mesh_blocks(active, 1.0, 0.4, 10) if b[3] is not None]
    for (_, _, _, pts), gv, wv in zip(blocks, volumes["port"], volumes["jax"]):
        bad = np.abs(gv - wv).reshape(-1) > 1e-5
        if jitter and bad.any():
            raise AssertionError(f"{int(bad.sum())} volume values off by > 1e-5")
        if bad.any():
            d = np.sort(np.linalg.norm(pts[bad][:, None] - active[None], axis=-1), axis=1)
            tie = (d[:, 2] - d[:, 1] < 1e-5) | (np.abs(d[:, 0] - 1.0) < 1e-5)
            assert tie.all(), d[~tie][:5]
