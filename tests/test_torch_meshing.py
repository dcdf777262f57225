"""The port's mesh extraction against the JAX package's on the CPU.

An analytic sphere stub (as in tests/test_meshing.py) gives both packages
the same volume, so vertices, faces and colours must be equal. A small map
trained by the port, with the same weights in both packages, must give
every block's volume within 1e-5 of JAX's no-drop route (JAX's capacity
route with a capacity no chunk can exceed; its drop count is asserted 0),
meshes within 1e-3 m in accuracy and completion, and colours within 1e-5
of JAX's field at the port's vertices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np
from test_torch_engine import DS_CFG, tiny_config

from neural_graph_mapping_tpu.mapping import meshing as jmeshing
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.eval import mesh_metrics
from neural_graph_mapping_tpu_torch.mapping import engine, meshing
from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet


def _sphere_outputs(points: np.ndarray, occupancy: bool) -> np.ndarray:
    """Numpy field: geometry = SDF of a unit sphere (or an occupancy logit),
    colour from the direction; the same float ops for both packages."""
    r = np.linalg.norm(points, axis=-1)
    geo = 5.0 * (1.0 - r) if occupancy else r - 1.0
    color = 0.5 + 0.5 * points / np.maximum(r[:, None], 1e-6)
    return np.concatenate([color, geo[:, None]], axis=-1).astype(np.float32)


class JaxSphere:
    """Duck-typed JAX field set (the capacity route meshing takes on the CPU)."""

    def __init__(self, occupancy=False):
        self.occupancy = occupancy

    def apply_knn(self, params, points, positions, orientations, valid, capacity,
                  field_radius=None, num_knn=None, with_stats=False):
        out = jnp.asarray(_sphere_outputs(np.asarray(points), self.occupancy))
        return (out, jnp.int32(0)) if with_stats else out


class PortSphere:
    """Duck-typed port field set; records the radius of each call."""

    def __init__(self, occupancy=False):
        self.occupancy = occupancy
        self.radii = []

    def apply_knn_tiled(self, params, points, positions, orientations, valid, field_radius=None):
        self.radii.append(field_radius)
        return torch.from_numpy(_sphere_outputs(points.numpy(), self.occupancy))


def _both_sphere_meshes(block_size, geometry_mode="nrgbd", tmp_path=None):
    occupancy = geometry_mode == "occupancy"
    kw = dict(field_radius=1.5, geometry_mode=geometry_mode, geometry_factor=1.0, resolution=0.1,
              block_size=block_size)
    want = jmeshing.extract_mesh(
        JaxSphere(occupancy), {}, jnp.zeros((1, 3)), jnp.asarray([[1.0, 0, 0, 0]]),
        jnp.ones(1, bool), **kw,
    )
    port = PortSphere(occupancy)
    got = meshing.extract_mesh(
        port, {}, torch.zeros((1, 3)), torch.tensor([[1.0, 0, 0, 0]]), torch.ones(1, dtype=torch.bool),
        mesh_file_path=None if tmp_path is None else tmp_path / "sphere.ply", **kw,
    )
    return want, got, port


@pytest.mark.parametrize("block_size", [64, 16, 12], ids=["one-block", "64-blocks", "125-blocks"])
def test_sphere_mesh_equals_jax(block_size):
    want, got, port = _both_sphere_meshes(block_size)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    r = np.linalg.norm(got.vertices, axis=1)
    assert abs(r.mean() - 1.0) < 0.05


def test_sphere_occupancy_mesh_equals_jax():
    want, got, _ = _both_sphere_meshes(32, "occupancy")
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


def test_recolour_pass_takes_radius_plus_a_tenth(tmp_path):
    """Volumes at the field set's radius, colours at radius + 0.1; the PLY
    and the field list are written."""
    _, got, port = _both_sphere_meshes(32, tmp_path=tmp_path)
    # each block: its volume, then (where the surface crosses) its colours
    assert set(port.radii) == {1.5, 1.5 + 0.1} and port.radii[0] == 1.5
    assert all(port.radii[i - 1] == 1.5 for i, r in enumerate(port.radii) if r != 1.5)
    assert (tmp_path / "sphere.ply").is_file() and (tmp_path / "sphere_fields.txt").is_file()


def test_no_fields_returns_none():
    out = meshing.extract_mesh(
        PortSphere(), {}, torch.zeros((4, 3)), torch.tensor([[1.0, 0, 0, 0]] * 4),
        torch.zeros(4, dtype=torch.bool), field_radius=1.0, geometry_mode="nrgbd", geometry_factor=1.0,
    )
    assert out is None


# -- a trained map -----------------------------------------------------------------

EVAL_CHUNK = 1536
RESOLUTION = 0.4


@pytest.fixture(scope="module")
def trained():
    """Three frames of a tiny map, its state as numpy."""
    ds = SyntheticDataset(DS_CFG)
    ds.load_slam_results()
    cfg = tiny_config()
    ngm = engine.NeuralGraphMap(cfg, "cpu")
    for fid in range(3):
        ngm.process_frame(ds, fid, ds[fid]["rgbd"])
    m = ngm._map_arrays
    valid = np.arange(ngm.capacity) < ngm.num_fields
    return cfg, to_np(ngm._params), to_np(m.positions), to_np(m.orientations), valid


class CountingJaxFieldSet:
    """The JAX field set with every capacity-route call's drop count kept."""

    def __init__(self, fset):
        self.fset = fset
        self.dropped = []

    def apply_knn(self, *args, with_stats=False, **kwargs):
        out, dropped = self.fset.apply_knn(*args, with_stats=True, **kwargs)
        self.dropped.append(int(dropped))
        return (out, dropped) if with_stats else out


def _record_volumes(monkeypatch, module):
    volumes = []
    orig = module.native.marching_tetrahedra

    def record(vol, iso):
        volumes.append(np.array(vol))
        return orig(vol, iso)

    monkeypatch.setattr(module.native, "marching_tetrahedra", record)
    return volumes


def _both_trained_meshes(trained, monkeypatch, jitter: float):
    """Mesh the trained map in both packages -> (JAX mesh, port mesh, JAX
    volumes, port volumes, field positions). ``jitter`` moves every field
    centre by seeded noise of that scale (m)."""
    cfg, params, positions, orientations, valid = trained
    positions = positions + np.random.default_rng(5).normal(0.0, jitter, positions.shape).astype(np.float32)
    mk = cfg["model_kwargs"]
    kw = dict(field_radius=cfg["field_radius"], geometry_mode=cfg["geometry_mode"],
              geometry_factor=cfg["geometry_factor"], resolution=RESOLUTION, block_size=10,
              eval_chunk=EVAL_CHUNK)
    jfs = CountingJaxFieldSet(JaxFieldSet(**mk))
    jax_volumes = _record_volumes(monkeypatch, jmeshing)
    want = jmeshing.extract_mesh(
        jfs, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(positions),
        jnp.asarray(orientations), jnp.asarray(valid), knn_capacity=EVAL_CHUNK * mk["num_knn"], **kw,
    )
    assert jfs.dropped and sum(jfs.dropped) == 0
    port_volumes = _record_volumes(monkeypatch, meshing)
    stats = {}
    got = meshing.extract_mesh(
        NeuralFieldSet(**mk), interop.params_from_jax(params, "cpu"), torch.from_numpy(positions),
        torch.from_numpy(orientations), torch.from_numpy(valid), stats=stats, **kw,
    )
    assert want is not None and got is not None
    assert stats["blocks_evaluated"] == len(port_volumes) == len(jax_volumes) > 1
    assert stats["eval_s"] > 0 and stats["march_s"] > 0
    return want, got, jax_volumes, port_volumes, positions


def test_trained_map_volumes_differ_from_jax_only_at_ties(trained, monkeypatch):
    """The map as trained: its fields sit on an allocation lattice, so grid
    points can lie equally far (to an ulp) from their second and third
    field, and the two distance formulas (the port's (p - c)^2, JAX's
    |p|^2 + |c|^2 - 2 p.c) may then pick different second fields. Every
    value off by more than 1e-5 must be such a tie, or sit within an ulp
    of the radius."""
    _, _, jax_volumes, port_volumes, positions = _both_trained_meshes(trained, monkeypatch, 0.0)
    active = positions[trained[4]]
    radius = trained[0]["field_radius"]
    blocks = [b for b in meshing.mesh_blocks(active, radius, RESOLUTION, 10) if b[3] is not None]
    off, total = 0, 0
    for (_, _, _, pts), gv, wv in zip(blocks, port_volumes, jax_volumes):
        bad = np.abs(gv - wv).reshape(-1) > 1e-5
        total += bad.size
        if not bad.any():
            continue
        off += int(bad.sum())
        d = np.sort(np.linalg.norm(pts[bad][:, None] - active[None], axis=-1), axis=1)
        tie = (d[:, 2] - d[:, 1] < 1e-5) | (np.abs(d[:, 0] - radius) < 1e-5)
        assert tie.all(), d[~tie][:5]
    assert off < 0.02 * total


def test_trained_map_mesh_matches_jax_no_drop_route(trained, monkeypatch):
    """Field centres moved by ~1 mm of seeded noise, so no grid point ties:
    every block's volume within 1e-5 of JAX's."""
    want, got, jax_volumes, port_volumes, positions = _both_trained_meshes(trained, monkeypatch, 1e-3)
    for gv, wv in zip(port_volumes, jax_volumes):
        assert gv.shape == wv.shape
        np.testing.assert_allclose(gv, wv, atol=1e-5, rtol=0)
    m = mesh_metrics.accuracy_completion_metrics(got.vertices, want.vertices)
    assert m["accuracy"] <= 1e-3 and m["completion"] <= 1e-3, m
    # colours: JAX's field at the port's vertices, at the recolour radius
    cfg, params, _, orientations, valid = trained
    jfs = JaxFieldSet(**cfg["model_kwargs"])
    colors, dropped = jfs.apply_knn(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(got.vertices), jnp.asarray(positions),
        jnp.asarray(orientations), jnp.asarray(valid), capacity=len(got.vertices),
        field_radius=cfg["field_radius"] + 0.1, with_stats=True,
    )
    assert int(dropped) == 0
    np.testing.assert_allclose(got.vertex_colors, np.clip(np.asarray(colors)[:, :3], 0.0, 1.0), atol=1e-5, rtol=0)


def test_apply_knn_tiled_radius_override_matches_jax(trained):
    """Points between the field radius and radius + 0.1 get blended values,
    not ``outside_value``, exactly where JAX's override puts them."""
    cfg, params, positions, orientations, valid = trained
    mk = cfg["model_kwargs"]
    rng = np.random.default_rng(3)
    live = positions[valid]
    dirs = rng.normal(size=(600, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = (live[rng.integers(0, len(live), 600)] + dirs * rng.uniform(0.9, 1.2, (600, 1))).astype(np.float32)
    radius = cfg["field_radius"] + 0.1
    jfs = JaxFieldSet(**mk)
    want, dropped = jfs.apply_knn(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts), jnp.asarray(positions),
        jnp.asarray(orientations), jnp.asarray(valid), capacity=2048, field_radius=radius, with_stats=True,
    )
    assert int(dropped) == 0
    tfs = NeuralFieldSet(**mk)
    tp = interop.params_from_jax(params, "cpu")
    args = (torch.from_numpy(pts), torch.from_numpy(positions), torch.from_numpy(orientations),
            torch.from_numpy(valid))
    got = to_np(tfs.apply_knn_tiled(tp, *args, field_radius=radius))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    base = to_np(tfs.apply_knn_tiled(tp, *args))
    widened = (base == tfs.outside_value).all(-1) & (got != tfs.outside_value).any(-1)
    assert widened.sum() > 10  # the override changed which points are inside
