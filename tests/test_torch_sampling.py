"""Parity of the port's target samplers, field allocation, map registry and
per-field Adam with the JAX package, on JAX's own replayed draws (same key,
same split order), plus the pinned divergence of the Adam write-back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch

from neural_graph_mapping_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from neural_graph_mapping_tpu.mapping import map_state as jmap_state
from neural_graph_mapping_tpu.mapping import optimizer as joptimizer
from neural_graph_mapping_tpu.mapping import sampling as jsampling
from neural_graph_mapping_tpu.utils import transforms as jtransforms
from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.mapping import map_state, optimizer, sampling
from neural_graph_mapping_tpu_torch.utils import transforms


def _masks(n, n_alloc, n_obs, seed):
    rng = np.random.default_rng(seed)
    alloc = np.arange(n) < n_alloc
    obs = alloc & (rng.uniform(size=n) < n_obs / max(n_alloc, 1))
    return obs, alloc


@pytest.mark.parametrize("n_alloc,n_obs", [(40, 20), (40, 3), (5, 2), (0, 0)])
def test_select_target_fields(n_alloc, n_obs):
    """Exact ids and validity, including the backfill of missing observed
    slots and the invalid slots' point-at-field-0 convention."""
    obs, alloc = _masks(64, n_alloc, n_obs, n_alloc + n_obs)
    key = jax.random.PRNGKey(n_alloc)
    want_ids, want_ok = jsampling.select_target_fields(key, jnp.asarray(obs), jnp.asarray(alloc), 8)
    k1, k2 = jax.random.split(key)
    got_ids, got_ok = sampling.select_target_fields(
        torch.from_numpy(obs), torch.from_numpy(alloc), 8,
        to_torch(jax.random.uniform(k1, (64,))), to_torch(jax.random.uniform(k2, (64,))),
    )
    np.testing.assert_array_equal(to_np(got_ok), np.asarray(want_ok))
    np.testing.assert_array_equal(to_np(got_ids), np.asarray(want_ids))
    ids = to_np(got_ids)[to_np(got_ok)]
    assert len(set(ids.tolist())) == len(ids) == min(8, n_alloc)


@pytest.fixture(scope="module")
def scene():
    """Cached keyframes (bf16 RGB + f32 depth) of a small synthetic scene."""
    cfg = {"num_frames": 12, "width": 32, "height": 24, "fx": 28.0, "fy": 28.0}
    ds = SyntheticDataset(cfg)
    ds.load_slam_results()
    jds = JaxSynthetic(cfg)
    frames = [0, 3, 6, 9]
    s = 6  # two empty slots
    rgbd = np.stack([ds[i]["rgbd"] for i in frames])
    np.testing.assert_allclose(rgbd, np.stack([jds[i]["rgbd"] for i in frames]), atol=1e-5)
    cache_rgb = np.zeros((s, 24, 32, 3), np.float32)
    cache_rgb[: len(frames)] = rgbd[..., :3]
    cache_depth = np.zeros((s, 24, 32), np.float32)
    cache_depth[: len(frames)] = rgbd[..., 3]
    cache_c2w = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
    cache_c2w[: len(frames)] = ds.gt_c2ws[frames]
    cache_valid = np.arange(s) < len(frames)
    rng = np.random.default_rng(0)
    positions = rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)
    return dict(
        ds=ds, jcam=jds.camera, tcam=ds.camera, cache_rgb=cache_rgb, cache_depth=cache_depth,
        cache_c2w=cache_c2w, cache_valid=cache_valid, positions=positions,
    )


def test_cameras_agree(scene):
    jc, tc = scene["jcam"], scene["tcam"]
    assert (jc.width, jc.height, jc.fx, jc.fy, jc.cx, jc.cy) == (
        tc.width, tc.height, tc.fx, tc.fy, tc.cx, tc.cy)
    rng = np.random.default_rng(1)
    ijs = rng.uniform(0, 24, (50, 2)).astype(np.float32)
    assert_close(jc.ijs_to_directions(jnp.asarray(ijs)), tc.ijs_to_directions(torch.from_numpy(ijs)), atol=1e-6)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32) - np.array([0, 0, 2], np.float32)
    for conv in ("opengl", "opencv"):
        want, want_front = jc.project_points(jnp.asarray(pts), conv)
        got, got_front = tc.project_points(torch.from_numpy(pts), conv)
        assert_close(want, got, atol=1e-4, rtol=1e-6)
        np.testing.assert_array_equal(to_np(got_front), np.asarray(want_front))
    depth = scene["cache_depth"][0]
    for a, b in zip(jc.depth_to_points_full(jnp.asarray(depth)), tc.depth_to_points_full(torch.from_numpy(depth))):
        assert_close(a, b, atol=1e-6)
    c2w = scene["cache_c2w"][1]
    assert_close(
        jtransforms.transform_points(jnp.asarray(pts), jnp.asarray(c2w), inv=True),
        transforms.transform_points(torch.from_numpy(pts), torch.from_numpy(c2w), inv=True),
        atol=1e-6,
    )


def test_sample_target_mv_on_replayed_draws(scene):
    """Same targets as the JAX sampler: pixels, keyframe poses and masks
    exact, distances within 1e-5."""
    f, r = 4, 64
    field_ids = np.array([3, 0, 7, 12])
    field_valid = np.array([True, True, False, True])
    s = scene["cache_c2w"].shape[0]
    key = jax.random.PRNGKey(5)
    cache = [scene[k] for k in ("cache_rgb", "cache_depth", "cache_c2w", "cache_valid")]
    jcache = [jnp.asarray(cache[0], jnp.bfloat16)] + [jnp.asarray(c) for c in cache[1:]]
    tcache = [torch.from_numpy(cache[0]).to(torch.bfloat16)] + [torch.from_numpy(c) for c in cache[1:]]
    want = jsampling.sample_target_mv(
        key, scene["jcam"], jnp.asarray(field_ids, jnp.int32), jnp.asarray(field_valid),
        jnp.asarray(scene["positions"]), *jcache, 1.0, r,
    )
    k_off, k_kf, k_pix = jax.random.split(key, 3)
    gumbel = jax.random.gumbel(k_kf, (f, r, s))
    # categorical(key, logits) is argmax(logits + gumbel(key)) over this shape
    logits = jnp.zeros((f, 1, s))
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(k_kf, logits, shape=(f, r))),
        np.asarray(jnp.argmax(gumbel + logits, axis=-1)),
    )
    got = sampling.sample_target_mv(
        scene["tcam"], torch.from_numpy(field_ids), torch.from_numpy(field_valid),
        torch.from_numpy(scene["positions"]), *tcache, 1.0, r,
        offsets=to_torch(jax.random.normal(k_off, (20, 3))), kf_gumbel=to_torch(gumbel),
        pix_u=to_torch(jax.random.uniform(k_pix, (f, r, 2))),
    )
    for name in ("ijs", "field_ids", "field_valid", "rgb_mask", "depth_mask", "term_mask"):
        np.testing.assert_array_equal(to_np(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("c2ws", "rgbds", "term_probs"):
        assert_close(getattr(want, name), getattr(got, name), atol=0, err_msg=name)
    for name in ("near_distances", "far_distances", "gt_distances"):
        assert_close(getattr(want, name), getattr(got, name), atol=1e-5, err_msg=name)
    assert to_np(got.field_valid).sum() >= 2  # the scene is visible


def test_observed_fields_mask_on_replayed_draws(scene):
    depth = scene["cache_depth"][1]
    c2w = scene["cache_c2w"][1]
    pos = scene["positions"]
    alloc = np.arange(16) < 14
    key = jax.random.PRNGKey(2)
    want = jsampling.observed_fields_mask(
        key, scene["jcam"], jnp.asarray(depth), jnp.asarray(c2w), jnp.asarray(pos),
        jnp.asarray(alloc), 0.5,
    )
    got = sampling.observed_fields_mask(
        scene["tcam"], torch.from_numpy(depth), torch.from_numpy(c2w), torch.from_numpy(pos),
        torch.from_numpy(alloc), 0.5, gumbel=to_torch(jax.random.gumbel(key, (500, depth.size))),
    )
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert to_np(got).sum() > 0


def test_uncovered_cells_on_replayed_shift(scene):
    """Same new-field centers as the JAX allocator for the same grid shift,
    with and without existing fields."""
    tcam = scene["tcam"]
    depth = torch.from_numpy(scene["cache_depth"][0])
    c2w = torch.from_numpy(scene["cache_c2w"][0])
    pts_c, _, valid = tcam.depth_to_points_full(depth)
    pts_w = torch.where(valid[:, None], transforms.transform_points(pts_c, c2w), torch.zeros(1))
    radius = 0.5
    for n_existing in (0, 6):
        fpos = scene["positions"][:16]
        fval = np.arange(16) < n_existing
        key = jax.random.PRNGKey(n_existing)
        want_c, want_n = jmap_state.uncovered_cells(
            key, jnp.asarray(to_np(pts_w)), jnp.asarray(to_np(valid)), jnp.asarray(fpos),
            jnp.asarray(fval), radius, 64,
        )
        shift = jax.random.uniform(key, (3,), minval=0.0, maxval=jmap_state.field_cell_size(radius))
        got_c, got_n = map_state.uncovered_cells(
            pts_w, valid, torch.from_numpy(fpos), torch.from_numpy(fval), radius, 64,
            shift=to_torch(shift),
        )
        assert int(got_n) == int(want_n) > 0
        assert_close(want_c, got_c, atol=1e-5)


def test_map_registry_ops():
    """grow_capacity, append_fields and reanchor_field_poses match JAX."""
    rng = np.random.default_rng(3)
    j_arr = jmap_state.init_map_arrays(4)
    t_arr = map_state.init_map_arrays(4)
    centers = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    j_arr = jmap_state.grow_capacity(j_arr, 7)
    t_arr = map_state.grow_capacity(t_arr, 7)
    j_arr = jmap_state.append_fields(j_arr, 2, jnp.asarray(centers), 3, 9, 4)
    t_arr = map_state.append_fields(t_arr, 2, torch.from_numpy(centers), 3, 9, 4)
    for name in j_arr._fields:
        np.testing.assert_array_equal(to_np(getattr(t_arr, name)), np.asarray(getattr(j_arr, name)), err_msg=name)

    def pose(seed):
        q = np.random.default_rng(seed).normal(size=4)
        q /= np.linalg.norm(q)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.asarray(jtransforms.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))
        m[:3, 3] = np.random.default_rng(seed + 1).normal(size=3)
        return m

    prev = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    new = prev.copy()
    prev[4], new[4] = pose(1), pose(2)
    new[0, 0, 0] = np.nan  # a lost keyframe leaves its fields untouched
    want = jmap_state.reanchor_field_poses(j_arr, jnp.asarray(prev), jnp.asarray(new))
    got = map_state.reanchor_field_poses(t_arr, torch.from_numpy(prev), torch.from_numpy(new))
    assert_close(want.positions, got.positions, atol=1e-5)
    assert_close(want.orientations, got.orientations, atol=1e-5)


def _adam_inputs(n, ids, seed):
    rng = np.random.default_rng(seed)
    params = {
        "enc.table": rng.normal(0, 1e-2, (n, 2, 2, 16)).astype(np.float32),
        "w0": rng.normal(0, 0.3, (n, 4, 3)).astype(np.float32),
        "b0": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
    }
    m = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in params.items()}
    v = {k: rng.uniform(0, 1e-4, p.shape).astype(np.float32) for k, p in params.items()}
    steps = rng.integers(0, 5, (n,)).astype(np.int32)
    grads = {k: rng.normal(0, 1e-2, (len(ids),) + p.shape[1:]).astype(np.float32) for k, p in params.items()}
    return params, m, v, steps, grads


def _adam_both(params, m, v, steps, grads, ids, valid):
    cfg = joptimizer.AdamConfig(learning_rate=1e-3, eps=1e-15, weight_decay=1e-5)
    tcfg = optimizer.AdamConfig(**cfg._asdict())
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    jstate = joptimizer.AdamState(
        m={k: jnp.asarray(x) for k, x in m.items()}, v={k: jnp.asarray(x) for k, x in v.items()},
        steps=jnp.asarray(steps),
    )
    j_ids = jnp.asarray(ids, jnp.int32)
    want_p, want_s = joptimizer.adam_slice_update(
        cfg, jp, jstate, j_ids, jnp.asarray(valid), {k: jnp.asarray(g) for k, g in grads.items()},
        {k: x[j_ids] for k, x in jp.items()},
    )
    tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
    tstate = optimizer.AdamState(
        m={k: torch.from_numpy(x.copy()) for k, x in m.items()},
        v={k: torch.from_numpy(x.copy()) for k, x in v.items()},
        steps=torch.from_numpy(steps.copy()),
    )
    t_ids = torch.from_numpy(np.array(ids))
    got_p, got_s = optimizer.adam_slice_update(
        tcfg, tp, tstate, t_ids, torch.from_numpy(np.array(valid)),
        {k: torch.from_numpy(g) for k, g in grads.items()},
        {k: x[t_ids] for k, x in tp.items()},
    )
    return (want_p, want_s), (got_p, got_s)


def test_adam_slice_update_on_distinct_ids():
    """Same gradients into both optimizers, distinct ids (some invalid):
    parameters, moments and step counts agree to f32 rounding of the step."""
    ids = np.array([5, 1, 6, 2])
    valid = np.array([True, True, False, True])
    params, m, v, steps, grads = _adam_inputs(8, ids, 0)
    (want_p, want_s), (got_p, got_s) = _adam_both(params, m, v, steps, grads, ids, valid)
    for k in params:
        assert_close(want_p[k], got_p[k], atol=1e-7, rtol=1e-6, err_msg=k)
        assert_close(want_s.m[k], got_s.m[k], atol=1e-9, rtol=1e-6, err_msg=k)
        assert_close(want_s.v[k], got_s.v[k], atol=1e-12, rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(to_np(got_s.steps), np.asarray(want_s.steps))
    # the invalid slot's field (6) is untouched
    np.testing.assert_array_equal(to_np(got_p["w0"][6]), params["w0"][6])


def test_adam_invalid_slots_do_not_clobber_field_0():
    """Pinned divergence from the JAX package. With fewer allocated fields
    than slots, select_target_fields points invalid slots at field 0; the JAX
    adam_slice_update scatters every slot, so field 0's stale values
    overwrite its own update (it neither moves nor counts an Adam step).
    The port writes back valid slots only: field 0 moves and counts."""
    obs, alloc = _masks(32, 3, 1, 0)
    key = jax.random.PRNGKey(0)
    ids, valid = jsampling.select_target_fields(key, jnp.asarray(obs), jnp.asarray(alloc), 8)
    ids, valid = np.asarray(ids), np.asarray(valid)
    assert 0 in ids[valid] and (~valid).sum() > 0 and (ids[~valid] == 0).all()
    params, m, v, steps, grads = _adam_inputs(32, ids, 1)
    (want_p, want_s), (got_p, got_s) = _adam_both(params, m, v, steps, grads, ids, valid)
    # JAX: field 0 unchanged, no step counted (the fault)
    np.testing.assert_array_equal(np.asarray(want_p["w0"][0]), params["w0"][0])
    assert int(want_s.steps[0]) == steps[0]
    # port: field 0 updated and counted
    assert not np.array_equal(to_np(got_p["w0"][0]), params["w0"][0])
    assert int(got_s.steps[0]) == steps[0] + 1
    # the other valid fields agree between the two
    for fid in ids[valid]:
        if fid != 0:
            assert_close(want_p["w0"][fid], got_p["w0"][fid], atol=1e-7, rtol=1e-6)
