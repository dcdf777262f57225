"""The port's ``vis/*`` against the JAX package's.

- ``edit_fields`` on the same map arrays: positions exact, orientations
  within 1e-6 (position, translate and transform edits; bad edits raise).
- ``simplify_mesh`` on one mesh: the same vertex and face counts and the
  same printed line as JAX's.
- ``vis_mesh`` / ``vis_dataset`` without rerun exit with JAX's messages.
- ``vis_checkpoint.main`` on the CPU on a checkpoint the port wrote: loads
  it, applies a rigid transform to every field, renders, saves; the saved
  poses are the edited ones, and a render of the transformed pose equals
  the unedited render of the original pose.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DS_CFG, tiny_config

from neural_graph_mapping_tpu.mapping.map_state import MapArrays as JaxMapArrays
from neural_graph_mapping_tpu.vis import simplify_mesh as jsimplify
from neural_graph_mapping_tpu.vis import vis_checkpoint as jvis_checkpoint
from neural_graph_mapping_tpu_torch import run_mapping
from neural_graph_mapping_tpu_torch.mapping.map_state import MapArrays
from neural_graph_mapping_tpu_torch.utils import meshio
from neural_graph_mapping_tpu_torch.vis import simplify_mesh, vis_checkpoint, vis_dataset, vis_mesh

SYNTHETIC = "neural_graph_mapping_tpu.datasets.synthetic.SyntheticDataset"


def _rigid(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    t[:3, 3] = rng.uniform(-1, 1, 3)
    return t


def _map_arrays(n, seed):
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return dict(
        positions=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        orientations=quats,
        kf_ids=np.arange(n, dtype=np.int32),
        kf_slots=np.arange(n, dtype=np.int32),
        training_iterations=np.full(n, 7, np.int32),
    )


def test_edit_fields_matches_jax():
    arrays = _map_arrays(10, 0)
    edits = [
        {"field_id": 3, "position": [1.0, 0.5, 0.0]},
        {"field_ids": [0, 1, 3], "translate": [0.1, 0.0, -0.2]},
        {"field_ids": list(range(8)), "transform": _rigid(1).tolist()},
        {"field_id": 9, "transform": _rigid(2).tolist()},
    ]
    want = jvis_checkpoint.edit_fields(
        JaxMapArrays(**{k: jnp.asarray(v) for k, v in arrays.items()}), edits, 10)
    got = vis_checkpoint.edit_fields(MapArrays(**{k: torch.from_numpy(v) for k, v in arrays.items()}), edits, 10)
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_allclose(got.orientations.numpy(), np.asarray(want.orientations), atol=1e-6, rtol=0)
    for k in ("kf_ids", "kf_slots", "training_iterations"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), arrays[k])
    with pytest.raises(ValueError, match="out-of-range"):
        vis_checkpoint.edit_fields(got, [{"field_id": 10, "translate": [0, 0, 0]}], 10)
    with pytest.raises(ValueError, match="exactly one"):
        vis_checkpoint.edit_fields(got, [{"field_ids": [0, 1], "position": [0, 0, 0]}], 10)
    with pytest.raises(ValueError, match="needs position"):
        vis_checkpoint.edit_fields(got, [{"field_id": 0}], 10)


def _grid_mesh(n=24):
    """A bumpy height field of (n + 1)^2 vertices and 2 n^2 triangles."""
    yy, xx = np.mgrid[0:n + 1, 0:n + 1].astype(np.float32) / n
    verts = np.stack([xx, yy, 0.1 * np.sin(6 * xx) * np.cos(5 * yy)], -1).reshape(-1, 3)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    i = i.reshape(-1)
    faces = np.concatenate([np.stack([i, i + 1, i + n + 2], -1), np.stack([i, i + n + 2, i + n + 1], -1)])
    colors = np.clip(verts * 0.5 + 0.5, 0, 1)
    return meshio.Mesh(verts, faces, colors)


def test_simplify_mesh_matches_jax(tmp_path, capsys):
    src = tmp_path / "in.ply"
    meshio.save_ply(src, _grid_mesh())
    jsimplify.main([str(src), str(tmp_path / "jax.ply"), "0.1"])
    want_line = capsys.readouterr().out
    simplify_mesh.main([str(src), str(tmp_path / "port.ply"), "0.1"])
    assert capsys.readouterr().out == want_line
    got, want = meshio.load_ply(tmp_path / "port.ply"), meshio.load_ply(tmp_path / "jax.ply")
    assert len(got.vertices) == len(want.vertices) < 625
    assert len(got.faces) == len(want.faces) < 1152
    with pytest.raises(SystemExit, match="usage"):
        simplify_mesh.main([str(src)])


def test_rerun_viewers_exit_without_rerun(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "rerun", None)  # as on a machine without rerun-sdk
    src = tmp_path / "m.ply"
    meshio.save_ply(src, _grid_mesh(4))
    with pytest.raises(SystemExit, match="rerun-sdk is required for mesh visualization"):
        vis_mesh.main([str(src)])
    with pytest.raises(SystemExit, match="usage"):
        vis_mesh.main([])
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps({"dataset_type": SYNTHETIC, "dataset_config": dict(DS_CFG, num_frames=2)}))
    with pytest.raises(SystemExit, match="rerun-sdk is required for dataset visualization"):
        vis_dataset.main(["--config", str(cfg)])


def test_vis_checkpoint_edits_a_port_checkpoint_on_the_cpu(tmp_path):
    cfg = tiny_config(
        model_type="neural_graph_mapping_tpu.models.fields.NeuralFieldSet",
        dataset_type=SYNTHETIC, dataset_config=dict(DS_CFG, num_frames=6),
        extract_mesh=False, disable_eval=True, eval_num_samples=32, out_dir=str(tmp_path / "runs"),
    )
    runner = run_mapping.NeuralGraphMapRunner(cfg, device="cpu")
    runner.fit()
    ckpt = runner.save_model(tmp_path / "map.npz")
    e = runner.engine
    c2w = np.asarray(runner.dataset.get_slam_c2ws(0, len(runner.dataset) - 1))
    state = e._init_gen.get_state()
    want, _ = e.render_image(c2w, runner.dataset.camera)

    n = e.num_fields
    t = _rigid(3)
    edit_cfg = tmp_path / "edit.json"
    edit_cfg.write_text(json.dumps(dict(
        json.loads(ckpt.with_suffix(".yaml").read_text()),
        edits=[{"field_ids": list(range(n)), "transform": t.tolist()}], frames=[0],
        save=str(tmp_path / "edited.npz"),
    )))
    edited, renders = vis_checkpoint.main(["--config", str(edit_cfg), "--device", "cpu"])
    assert set(renders) == {0} and bool(torch.isfinite(renders[0]).all())
    with np.load(tmp_path / "edited.npz") as data:
        pos = data["map.positions"][:n]
    np.testing.assert_allclose(pos, e._map_arrays.positions[:n].numpy() @ t[:3, :3].T + t[:3, 3], atol=1e-6)
    # the same jitter from the transformed pose: the same image
    edited.engine._init_gen.set_state(state)
    got, _ = edited.engine.render_image(t @ c2w, runner.dataset.camera)
    assert float((got - want).abs().max()) <= 1e-4
