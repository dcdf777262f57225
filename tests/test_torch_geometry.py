"""Parity of the port's L0 math (transforms, geometry) and of the state
carried across by interop with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import assert_close, run_both, to_np

from neural_graph_mapping_tpu import geometry as jgeometry
from neural_graph_mapping_tpu.mapping import map_state as jmap_state
from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
from neural_graph_mapping_tpu.utils import transforms as jtransforms
from neural_graph_mapping_tpu_torch import geometry, interop
from neural_graph_mapping_tpu_torch.utils import transforms


def _unit_quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternions():
    rng = np.random.default_rng(0)
    q, p = _unit_quats(20, 0), rng.normal(size=(20, 3)).astype(np.float32)
    for jfn, tfn in [
        (jtransforms.quaternion_apply, transforms.quaternion_apply),
        (lambda a, b: jtransforms.quaternion_apply(jtransforms.quaternion_invert(a), b),
         lambda a, b: transforms.quaternion_apply(transforms.quaternion_invert(a), b)),
    ]:
        want, got = run_both(jfn, tfn, q, p)
        assert_close(want, got, atol=1e-6)
    want, got = run_both(jtransforms.quaternion_multiply, transforms.quaternion_multiply, q, q[::-1].copy())
    assert_close(want, got, atol=1e-6)


def test_rigid_transforms():
    q = _unit_quats(6, 1)
    mats = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    mats[:, :3, :3] = np.asarray(jtransforms.quaternion_to_matrix(jnp.asarray(q)))
    mats[:, :3, 3] = np.random.default_rng(2).normal(size=(6, 3))
    pts = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
    for inv in (False, True):
        want, got = run_both(
            lambda a, b: jtransforms.transform_points(a, b, inv=inv),
            lambda a, b: transforms.transform_points(a, b, inv=inv), pts, mats,
        )
        assert_close(want, got, atol=1e-5)
    want, got = run_both(jtransforms.invert_rigid, transforms.invert_rigid, mats)
    assert_close(want, got, atol=1e-6)
    want, got = run_both(jtransforms.matrix_to_quaternion, transforms.matrix_to_quaternion, mats[:, :3, :3].copy())
    assert_close(want, got, atol=1e-6)
    want, got = run_both(jtransforms.transform_quaternions, transforms.transform_quaternions, q, mats)
    assert_close(want, got, atol=1e-6)


def test_segments_intersect_spheres():
    rng = np.random.default_rng(4)
    ends = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    starts = np.zeros_like(ends)
    centers = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    want, got = run_both(
        lambda a, b, c: jgeometry.segments_intersect_spheres(a, b, c, 0.5),
        lambda a, b, c: geometry.segments_intersect_spheres(a, b, c, 0.5),
        starts, ends, centers,
    )
    assert got.shape == (40, 300) and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def test_adam_and_map_arrays_from_jax():
    params = {"enc.table": np.ones((4, 2, 2, 8), np.float32), "w0": np.ones((4, 4, 3), np.float32),
              "b0": np.ones((4, 3), np.float32)}
    jstate = joptimizer.init_adam_state({k: jnp.asarray(v) for k, v in params.items()})
    state = interop.adam_from_jax(
        {k: np.asarray(v) for k, v in jstate.m.items()},
        {k: np.asarray(v) for k, v in jstate.v.items()}, np.asarray(jstate.steps), "cpu",
    )
    assert state.steps.shape == (4,) and set(state.m) == set(params)
    with pytest.raises(ValueError):
        interop.adam_from_jax(params, params, np.zeros((3,), np.int32), "cpu")
    arrays = jmap_state.append_fields(
        jmap_state.init_map_arrays(8), 0, jnp.ones((3, 3)), 3, 5, 2
    )
    got = interop.map_arrays_from_jax(*(np.asarray(a) for a in arrays), "cpu")
    for name in arrays._fields:
        np.testing.assert_array_equal(to_np(getattr(got, name)), np.asarray(getattr(arrays, name)))
    with pytest.raises(ValueError):
        interop.map_arrays_from_jax(
            np.zeros((8, 3)), np.zeros((8, 3)), np.zeros(8), np.zeros(8), np.zeros(8), "cpu"
        )


def test_synthetic_scene_bounds_stay_in_process_tempdir(tmp_path, monkeypatch):
    """The port's synthetic scene lives under the process's temp directory
    and ``scene_bounds`` writes no cache file there."""
    import tempfile

    from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ds = SyntheticDataset({"num_frames": 3, "width": 16, "height": 12, "fx": 14.0, "fy": 14.0})
    ds.load_slam_results()
    assert ds.scene_dir_path.parent == tmp_path
    bounds = ds.scene_bounds
    assert bounds.shape == (2, 3) and np.isfinite(bounds).all()
    assert (bounds[0] < bounds[1]).all()
    assert list(tmp_path.iterdir()) == []
