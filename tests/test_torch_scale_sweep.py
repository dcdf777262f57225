"""The port's field-count sweep (``neural_graph_mapping_tpu_torch.scripts.
scale_sweep``) against the JAX package's, on the CPU at the tiny size.

``grow_to`` is held to benchmarks/scale_sweep.py's growth, written out
below (that module points JAX's compile cache at a fixed path when
imported, so it is not imported): ``map_state.grow_capacity`` doubling,
params padded with zeros then mixed with fresh params on the new rows,
the new rows' pose, anchor and training count, zero Adam state, the
observed mask padded with the first 8 new fields marked. Both maps start
from the same frame (the port fed JAX's draws, then given JAX's params and
map arrays),
grow from 16 fields at capacity 32 to 40 fields at capacity 64 on the same
injected positions and fresh params, and must then hold equal map arrays,
observed masks and params; one training iteration on the grown maps, on
JAX's own draws (``engine.IterationDraws``), gives the same losses (rel
1e-4) and training counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np
from test_torch_engine import _replayed_draws, tiny_config
from test_torch_trajectory import SYNTH, JaxReplay

from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.mapping import engine as jengine
from neural_graph_mapping_tpu.mapping import map_state as jmap_state
from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import engine
from neural_graph_mapping_tpu_torch.scripts import scale_sweep

TARGET = 40


def jax_grow_to(ngm, n_target: int, new_pos, fresh) -> None:
    """benchmarks/scale_sweep.py's ``grow_to`` with its two draws (the new
    positions and the fresh params) given."""
    n_now = ngm.num_fields
    while ngm.capacity < n_target:
        ngm._map_arrays = jmap_state.grow_capacity(ngm._map_arrays, ngm.capacity * 2)
        ngm._params = jax.tree_util.tree_map(lambda p: jnp.concatenate([p, jnp.zeros_like(p)], axis=0), ngm._params)
    mask = (jnp.arange(ngm.capacity) >= n_now) & (jnp.arange(ngm.capacity) < n_target)

    def mix(old, new):
        m = mask.reshape((-1,) + (1,) * (old.ndim - 1))
        return jnp.where(m, new, old)

    ngm._params = jax.tree_util.tree_map(mix, ngm._params, fresh)
    ma = ngm._map_arrays
    ngm._map_arrays = ma._replace(
        positions=ma.positions.at[n_now:n_target].set(new_pos),
        orientations=ma.orientations.at[n_now:n_target].set(jnp.array([1.0, 0.0, 0.0, 0.0])),
        kf_ids=ma.kf_ids.at[n_now:n_target].set(0),
        training_iterations=ma.training_iterations.at[n_now:n_target].set(100),
    )
    ngm._num_fields = n_target
    ngm._adam = joptimizer.init_adam_state(ngm._params)
    obs = jnp.zeros((ngm.capacity,), bool).at[: ngm._observed_mask.shape[0]].set(ngm._observed_mask)
    ngm._observed_mask = obs | ((jnp.arange(ngm.capacity) >= n_now) & (jnp.arange(ngm.capacity) < n_now + 8))


@pytest.fixture(scope="module")
def grown():
    """JAX's map and the port's after frame 0 (the port on JAX's draws, its
    params and map arrays then set to JAX's), each grown to TARGET fields."""
    cfg = tiny_config(num_iterations_per_frame=2, max_new_fields=16)
    jds, ds = JaxSynthetic(SYNTH), SyntheticDataset(SYNTH)
    jds.load_slam_results()
    ds.load_slam_results()
    jm = jengine.NeuralGraphMap(cfg)
    replay = JaxReplay(cfg)
    tm = engine.NeuralGraphMap(cfg, "cpu", draws=replay)
    jm.process_frame(jds, 0, jnp.asarray(jds[0]["rgbd"]))
    tm.process_frame(ds, 0, ds[0]["rgbd"])
    n_now = tm.num_fields
    assert n_now == jm.num_fields == 16 and tm.capacity == jm.capacity == 32
    # one starting state: the lockstep frame leaves positions within 1e-5, not equal
    tm._params = interop.params_from_jax({k: np.asarray(v) for k, v in jm._params.items()}, "cpu")
    tm._map_arrays = interop.map_arrays_from_jax(*(np.asarray(a) for a in jm._map_arrays), "cpu")

    pos = np.asarray(jm._map_arrays.positions[:n_now])
    rng = np.random.default_rng(TARGET)
    new_pos = rng.uniform(pos.min(0) - 1.0, pos.max(0) + 1.0, (TARGET - n_now, 3)).astype(np.float32)
    fresh = replay.jfs.init_fields(jax.random.PRNGKey(TARGET), 64)
    before = {"observed": to_np(tm._observed_mask).copy(), "n_now": n_now}
    jax_grow_to(jm, TARGET, jnp.asarray(new_pos), fresh)
    scale_sweep.grow_to(tm, TARGET, positions=torch.from_numpy(new_pos),
                        fresh=interop.params_from_jax({k: np.asarray(v) for k, v in fresh.items()}, "cpu"))
    return cfg, jm, tm, before


def test_grow_to_matches_jax(grown):
    _, jm, tm, before = grown
    n_now = before["n_now"]
    assert tm.num_fields == jm.num_fields == TARGET and tm.capacity == jm.capacity == 64
    for name in ("positions", "orientations", "kf_ids", "kf_slots", "training_iterations"):
        np.testing.assert_array_equal(to_np(getattr(tm._map_arrays, name)), np.asarray(getattr(jm._map_arrays, name)),
                                      err_msg=name)
    observed = to_np(tm._observed_mask)
    np.testing.assert_array_equal(observed, np.asarray(jm._observed_mask))
    rows = np.arange(64)
    new_observed = (rows >= n_now) & (rows < n_now + 8)
    np.testing.assert_array_equal(observed[:n_now], before["observed"][:n_now])
    np.testing.assert_array_equal(observed[n_now:], new_observed[n_now:])
    want = {k: np.asarray(v) for k, v in jm._params.items()}
    got = {k: to_np(v) for k, v in tm._params.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(float(v.abs().max()) == 0.0 for v in (*tm._adam.m.values(), *tm._adam.v.values()))
    assert int(tm._adam.steps.abs().max()) == 0


def test_iteration_on_the_grown_map_matches_jax(grown):
    cfg, jm, tm, _ = grown
    f, r = cfg["num_train_fields"], cfg["num_rays_per_field"]
    key = jax.random.PRNGKey(7)
    allocated = jm._allocated_mask()
    _, _, want_ti, want = jengine.optimization_iteration(
        jm._fset, jm._camera, jm._rcfg, jm._ocfg, jm._loss_cfg, f, jm._params, jm._adam,
        jm._map_arrays.training_iterations, jm._map_arrays.positions, jm._map_arrays.orientations, allocated,
        jm._observed_mask, jm._cache_rgb, jm._cache_depth, jnp.asarray(jm._cache_c2w_np),
        jnp.asarray(jm._cache_valid_np), key,
    )
    draws = _replayed_draws(key, tm.capacity, f, r, cfg["num_kf_slots"], cfg["num_samples_coarse"],
                            cfg["num_samples_depth_guided"])
    _, _, got_ti, got = engine.optimization_iteration(
        tm._fset, tm._camera, tm._rcfg, tm._ocfg, tm._loss_cfg, f, tm._params, tm._adam,
        tm._map_arrays.training_iterations, tm._map_arrays.positions, tm._map_arrays.orientations,
        tm._allocated_mask(), tm._observed_mask, tm._cache_rgb, tm._cache_depth, tm._cache_c2w_dev,
        tm._cache_valid_dev, draws=draws,
    )
    assert set(got) == set(want)
    for k in want:
        assert_close(want[k], got[k], atol=1e-7, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(to_np(got_ti), np.asarray(want_ti))
    assert float(got["diag_valid_fields"]) > 0


def test_sweep_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """``sweep_one`` end to end with the workload, scene and render camera
    cut to the tiny size: the map grows to N, trains and renders (finite),
    and the result names its numbers."""
    monkeypatch.setattr(scale_sweep, "SCENE", dict(SYNTH, num_frames=scale_sweep.RENDER_FRAME + 1))
    monkeypatch.setattr(scale_sweep, "WORKLOAD", tiny_config(max_new_fields=16))
    monkeypatch.setattr(scale_sweep, "RENDER_CAMERA", {"width": 32, "height": 24, "fx": 28.0, "fy": 28.0,
                                                      "cx": 16.0, "cy": 12.0})
    monkeypatch.setattr(scale_sweep, "RENDER_BLOCK", 256)
    monkeypatch.setattr(scale_sweep, "RENDER_SPAN", 32)
    result, _, ngm = scale_sweep.sweep_one(100, "cpu")
    assert (result["n"], result["fields"], result["capacity"]) == (100, 100, 128)
    assert result["train_rays_per_s"] > 0 and result["render_ms_per_block"] > 0
    ti = ngm._map_arrays.training_iterations
    assert int(ti.max()) > 100 and int(ti[100:].abs().sum()) == 0  # new fields trained, padding untouched
    assert scale_sweep.sweep_one(1, "cpu")[0] is None  # the warm map has more fields than that


def test_sweep_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scale_sweep.main(["128"])


def _stable_sort_top2(points_fm, centers, valid):
    """The plain top-2's definition: a stable sort of the masked squared
    distances, first two of each row."""
    d = [points_fm[a][:, None] - centers[:, a][None, :] for a in range(3)]
    d2 = torch.where(valid[None, :], d[0] * d[0] + d[1] * d[1] + d[2] * d[2], torch.inf)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return torch.sqrt(vals[:, :2]).T, idx[:, :2].T.to(torch.int32)


@pytest.mark.parametrize("case", ["uniform", "ties", "one_valid"])
def test_plain_topk_at_many_centres_is_chunked_and_exact(case, monkeypatch):
    """``topk.topk2_fields_plain`` (the CPU path, and the card's reference)
    at 2,048 centres: a map of that many fields once took a (2^20, N)
    matrix and a sort of it a chunk, 8 GB a temporary at N = 2,048 (the
    card ran out of memory in the sweep's check). Its chunks now hold at
    most ``_PLAIN_ENTRIES`` entries (1,024 rows at the least), and its
    output equals a stable sort's: indices exact (ties to the lower
    index, also among +inf), distances bit for bit."""
    from neural_graph_mapping_tpu_torch.ops import topk

    n = 2048
    g = torch.Generator().manual_seed(n)
    pts = torch.rand((3, 5000), generator=g) * 4 - 2
    cen = torch.rand((n, 3), generator=g) * 6 - 3
    valid = torch.rand(n, generator=g) > 0.3
    if case == "ties":
        pts, cen = torch.round(pts), torch.round(cen)
        cen[n // 2] = cen[0]
    if case == "one_valid":
        valid[:] = False
        valid[n - 1] = True
    monkeypatch.setattr(topk, "_PLAIN_ENTRIES", 1 << 22)
    shapes = []
    argmin = torch.argmin

    def spy(x, *args, **kwargs):
        shapes.append(tuple(x.shape))
        return argmin(x, *args, **kwargs)

    monkeypatch.setattr(torch, "argmin", spy)
    d, i = topk.topk2_fields_plain(pts, cen, valid)
    monkeypatch.undo()
    assert shapes and all(r * c <= max(1024 * c, 1 << 22) for r, c in shapes), shapes
    assert sum(r for r, _ in shapes) == 2 * pts.shape[1]
    want_d, want_i = _stable_sort_top2(pts, cen, valid)
    assert torch.equal(i, want_i) and torch.equal(d, want_d)
