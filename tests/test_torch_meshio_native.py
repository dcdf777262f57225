"""The port's mesh IO and native geometry bindings against the JAX package's:
PLY round trips (binary with colours, ASCII with quads), and marching
tetrahedra and depth rasterization equal bit for bit (both packages build
the same C++ source with the same flags, each into its own library)."""

import numpy as np
import pytest

from neural_graph_mapping_tpu.ops import native as jnative
from neural_graph_mapping_tpu.utils import meshio as jmeshio
from neural_graph_mapping_tpu_torch.ops import native
from neural_graph_mapping_tpu_torch.utils import meshio


def sphere_grid(n=24, radius=1.0, seed=0):
    """SDF of a sphere on an n^3 grid, with seeded noise so no two cells tie."""
    grid = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    c = (n - 1) / 2
    scale = 2.5 * radius / n
    sdf = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) * scale - radius
    noise = np.random.default_rng(seed).normal(0.0, 0.01, sdf.shape)
    return (sdf + noise).astype(np.float32), c, scale


def test_builds_into_the_ports_own_directory():
    native.marching_tetrahedra(np.ones((4, 4, 4), np.float32), 0.0)
    path = native.library_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "neural_graph_mapping_tpu_torch"


@pytest.mark.parametrize("n,iso", [(8, 0.0), (24, 0.0), (24, 0.3), (17, -0.2)])
def test_marching_tetrahedra_equals_jax_exactly(n, iso):
    grid, _, _ = sphere_grid(n, seed=n)
    want_v, want_t = jnative.marching_tetrahedra(grid, iso)
    got_v, got_t = native.marching_tetrahedra(grid, iso)
    assert len(want_v) > 0 or n == 8
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_t, want_t)


def test_marching_tetrahedra_empty_grid():
    verts, tris = native.marching_tetrahedra(np.ones((8, 8, 8), np.float32), 0.0)
    assert len(verts) == 0 and len(tris) == 0


@pytest.mark.parametrize("pose", ["front", "tilted"])
def test_rasterize_depth_equals_jax_exactly(pose):
    grid, c, scale = sphere_grid(24)
    verts, tris = jnative.marching_tetrahedra(grid, 0.0)
    verts = ((verts - c) * scale).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 3.0
    if pose == "tilted":
        a = 0.3
        w2c[:3, :3] = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32
        )
        w2c[0, 3] = 0.2
    want = jnative.rasterize_depth(verts, tris, w2c, 60, 60, 32, 24, 64, 48)
    got = native.rasterize_depth(verts, tris, w2c, 60, 60, 32, 24, 64, 48)
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got, want)


def test_ply_roundtrip_binary_with_colors(tmp_path):
    grid, c, scale = sphere_grid(12)
    v, t = native.marching_tetrahedra(grid, 0.0)
    mesh = meshio.Mesh((v - c) * scale, t)
    mesh.vertex_colors = np.random.RandomState(0).rand(len(mesh.vertices), 3).astype(np.float32)
    path = tmp_path / "m.ply"
    meshio.save_ply(path, mesh)
    loaded = meshio.load_ply(path)
    np.testing.assert_array_equal(loaded.vertices, mesh.vertices)
    np.testing.assert_array_equal(loaded.faces, mesh.faces)
    np.testing.assert_array_equal(loaded.vertex_colors, mesh.vertex_colors)
    # the same bytes as the JAX package's writer, and its reader agrees
    jpath = tmp_path / "j.ply"
    jmeshio.save_ply(jpath, jmeshio.Mesh(mesh.vertices, mesh.faces, mesh.vertex_colors))
    assert jpath.read_bytes() == path.read_bytes()
    jloaded = jmeshio.load_ply(path)
    np.testing.assert_array_equal(jloaded.faces, loaded.faces)


def test_ply_ascii_with_quads(tmp_path):
    content = """ply
format ascii 1.0
element vertex 5
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 2
property list uchar int vertex_indices
end_header
0 0 0 255 0 0
1 0 0 0 255 0
1 1 0 0 0 255
0 1 0 255 255 255
0.5 0.5 1 10 20 30
4 0 1 2 3
3 0 1 4
"""
    path = tmp_path / "q.ply"
    path.write_text(content)
    got = meshio.load_ply(path)
    want = jmeshio.load_ply(path)
    assert got.faces.shape == (3, 3)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    assert got.vertex_colors.max() == 1.0


def test_mesh_helpers_equal_jax():
    grid, c, scale = sphere_grid(16)
    v, t = native.marching_tetrahedra(grid, 0.0)
    colors = np.random.RandomState(1).rand(len(v), 3).astype(np.float32)
    mesh = meshio.Mesh((v - c) * scale, t, colors)
    jmesh = jmeshio.Mesh((v - c) * scale, t, colors)
    np.testing.assert_array_equal(mesh.vertex_normals(), jmesh.vertex_normals())
    for got, want in zip(mesh.sample_surface(500, seed=3), jmesh.sample_surface(500, seed=3)):
        np.testing.assert_array_equal(got, want)
    sub, jsub = mesh.subdivide_to_size(0.1), jmesh.subdivide_to_size(0.1)
    np.testing.assert_array_equal(sub.vertices, jsub.vertices)
    np.testing.assert_array_equal(sub.faces, jsub.faces)
    simp, jsimp = mesh.simplify(0.2), jmesh.simplify(0.2)
    np.testing.assert_array_equal(simp.vertices, jsimp.vertices)
    np.testing.assert_array_equal(simp.faces, jsimp.faces)
    np.testing.assert_array_equal(simp.vertex_colors, jsimp.vertex_colors)
