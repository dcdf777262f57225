"""``Camera.sample_ijs_uniform`` of the port against the JAX package's.

JAX's cases (tests/test_camera_geometry.py, the sampling tests) on injected
draws: the uniforms JAX draws from its key are passed to the port as ``u``
(and ``r``), so points and distances agree within 1e-6 relative. Then the
port's own draws from a ``torch.Generator``: bin frequencies against the
probabilities the cumulative weights + 1e-3 give, within five binomial
standard deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from neural_graph_mapping_tpu.camera import Camera as JaxCamera
from neural_graph_mapping_tpu_torch.camera import Camera

CAM = dict(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)


def _stratified_draws(key, lead, s):
    return np.array(jax.random.uniform(key, lead + (s,)))


def _weighted_draws(key, lead, s):
    key_bin, key_u = jax.random.split(key)
    return (np.array(jax.random.uniform(key_bin, lead + (s,))),
            np.array(jax.random.uniform(key_u, lead + (s,))))


def _close(want, got):
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert_close(w, g, atol=1e-6 * float(np.abs(w).max()), rtol=1e-6)


@pytest.mark.parametrize("convention", ["opengl", "opencv"])
def test_stratified_matches_jax(convention):
    key = jax.random.PRNGKey(0)
    ijs = np.asarray([[24, 32]] * 4, np.float32)
    want = JaxCamera.create(**CAM).sample_ijs_uniform(key, jnp.asarray(ijs), 8, 1.0, 3.0, convention=convention)
    u = _stratified_draws(key, (4,), 8)
    got = Camera.create(**CAM).sample_ijs_uniform(
        torch.from_numpy(ijs), 8, 1.0, 3.0, convention=convention, u=torch.from_numpy(u))
    assert got[0].shape == (4, 8, 3) and got[1].shape == (4, 8)
    _close(want, got)
    d = got[1].numpy()
    assert (d >= 1.0).all() and (d <= 3.0).all()
    np.testing.assert_array_equal(d, np.sort(d, axis=-1))  # stratified: sorted within a ray


def test_per_ray_near_far_match_jax():
    key = jax.random.PRNGKey(1)
    ijs = np.zeros((3, 2), np.float32)
    near, far = np.asarray([0.0, 1.0, 2.0], np.float32), np.asarray([1.0, 2.0, 4.0], np.float32)
    want = JaxCamera.create(**CAM).sample_ijs_uniform(
        key, jnp.asarray(ijs), 16, jnp.asarray(near), jnp.asarray(far))
    got = Camera.create(**CAM).sample_ijs_uniform(
        torch.from_numpy(ijs), 16, torch.from_numpy(near), torch.from_numpy(far),
        u=torch.from_numpy(_stratified_draws(key, (3,), 16)))
    _close(want, got)
    d = got[1].numpy()
    assert (d >= near[:, None]).all() and (d <= far[:, None]).all()


@pytest.mark.parametrize("weights", [[0.5, 0.0, 0.5], [0.2, 0.3, 0.1], [0.0, 0.0, 0.0]])
def test_weighted_bins_match_jax(weights):
    key = jax.random.PRNGKey(2)
    ijs = np.zeros((2, 2), np.float32)
    boundaries = np.broadcast_to(np.asarray([1.0, 2.0, 3.0, 4.0], np.float32), (2, 4)).copy()
    w = np.broadcast_to(np.asarray(weights, np.float32), (2, 3)).copy()
    want = JaxCamera.create(**CAM).sample_ijs_uniform(
        key, jnp.asarray(ijs), 512, weights=jnp.asarray(w), boundaries=jnp.asarray(boundaries))
    r, u = _weighted_draws(key, (2,), 512)
    got = Camera.create(**CAM).sample_ijs_uniform(
        torch.from_numpy(ijs), 512, weights=torch.from_numpy(w), boundaries=torch.from_numpy(boundaries),
        r=torch.from_numpy(r), u=torch.from_numpy(u))
    assert got[0].shape == (2, 512, 3) and got[1].shape == (2, 512)
    _close(want, got)
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), got[1].numpy(), atol=1e-5)


def test_weighted_requires_both_and_draws_or_a_generator():
    cam = Camera.create(**CAM)
    with pytest.raises(ValueError, match="both or none"):
        cam.sample_ijs_uniform(torch.zeros((1, 2)), 4, weights=torch.ones((1, 3)) / 3)
    with pytest.raises(ValueError, match="generator"):
        cam.sample_ijs_uniform(torch.zeros((1, 2)), 4, 1.0, 2.0)


@pytest.mark.parametrize("weights", [[0.5, 0.0, 0.5], [0.1, 0.6, 0.3], [0.05, 0.05, 0.05, 0.85]])
def test_bin_frequencies_on_generator_draws(weights):
    """Bin k is drawn with probability P(c[k-1] <= r < c[k]) for the
    cumulative weights c + 1e-3 (the last bin takes every r past them);
    200,000 draws land in each bin within five standard deviations, and
    uniformly within it."""
    n_bins = len(weights)
    n = 200_000
    boundaries = torch.arange(n_bins + 1, dtype=torch.float32)[None]  # bin k is [k, k + 1)
    w = torch.tensor([weights], dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    _, d = Camera.create(**CAM).sample_ijs_uniform(
        torch.zeros((1, 2)), n, weights=w, boundaries=boundaries, generator=gen)
    d = d.numpy()[0]
    cum = np.cumsum(np.asarray(weights, np.float64)) + 1e-3
    edges = np.concatenate([[0.0], np.minimum(cum, 1.0)])
    probs = np.diff(edges)
    probs[-1] += 1.0 - edges[-1]
    counts = np.bincount(np.floor(d).astype(int), minlength=n_bins)
    assert counts.sum() == n and len(counts) == n_bins
    sigma = np.sqrt(n * probs * (1 - probs))
    assert (np.abs(counts - n * probs) <= 5 * sigma + 1).all(), (counts, n * probs)
    frac = d - np.floor(d)
    assert abs(frac.mean() - 0.5) < 0.01 and abs(frac.var() - 1 / 12) < 0.005


# -- examples/fit_synthetic.py, the sampler's user ------------------------------


def test_fit_synthetic_step_matches_jax():
    """One step of the example's loss on JAX's draws and weights: the JAX
    package's sample_ijs_uniform / apply_vmap / quadrature / losses (the
    example's loss, written out) against the port's ``ray_losses``; loss
    within 1e-5 relative, every parameter's gradient within 1e-4 of its
    largest entry."""
    from neural_graph_mapping_tpu.models import NeuralFieldSet as JaxFieldSet
    from neural_graph_mapping_tpu.ops import losses as jlosses
    from neural_graph_mapping_tpu.ops import quadrature as jquadrature
    from neural_graph_mapping_tpu_torch.examples import fit_synthetic as ex

    fset = ex.make_field_set()
    jfset = JaxFieldSet(
        dim_points=3, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=dict(
            encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
            encoding_kwargs=dict(pos_dim=3, log2_hashmap_size=12, nr_levels=16, nr_feat_per_level=2,
                                 coarsest_scale=1.0, finest_scale=1e-4, init_scale=1e-5),
            num_layers=1, dim_out=4,
        ),
        num_knn=2, distance_factor=10.0, outside_value=1.0, field_radius=1.0, scale_mode="unit_cube",
    )
    params = jfset.init_fields(jax.random.PRNGKey(0), 1)
    params = dict(params, **{"enc.table": params["enc.table"] * 1e4})  # a trained-looking table
    jcam = JaxCamera.create(**dict(CAM, width=80, height=60, fx=70.0, fy=70.0, cx=40.0, cy=30.0))
    cam = ex.make_camera()
    positions = jnp.asarray([ex.SPHERE_CENTER])
    orientations = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    r, s, trunc = 128, ex.SAMPLES, ex.TRUNC
    ijs = jax.random.uniform(k1, (r, 2)) * jnp.asarray([jcam.height - 1, jcam.width - 1])

    def jloss(p):
        dirs = jcam.ijs_to_directions(ijs, "opengl")
        oc = -jnp.asarray(ex.SPHERE_CENTER)
        b = jnp.sum(dirs * oc, axis=-1)
        c = jnp.sum(oc * oc) - ex.SPHERE_RADIUS**2
        disc = b * b - c
        hit = disc > 0
        t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
        gt_dist = jnp.where(hit & (t > 0), t, 0.0)
        normal = (dirs * gt_dist[..., None] - jnp.asarray(ex.SPHERE_CENTER)) / ex.SPHERE_RADIUS
        gt_color = jnp.where(hit[..., None], 0.5 + 0.5 * normal, 0.0)
        pts, dists = jcam.sample_ijs_uniform(k2, ijs, s, jnp.full((r,), ex.NEAR), jnp.full((r,), ex.FAR))
        outs = jfset.apply_vmap(p, pts.reshape(1, -1, 3), positions, orientations).reshape(r, s, 4)
        q = jquadrature.quadrature("nrgbd", outs[..., :3], outs[..., 3], dists, -pts[..., 2],
                                   geometry_factor=20.0)
        l_ph = jlosses.photometric_loss("l1", gt_color, q.colors, mask=hit)
        l_d = jlosses.depth_loss("huber", gt_dist, q.depths, mask=hit)
        fs_mask = (dists < (gt_dist[:, None] - trunc)) & hit[:, None]
        l_fs = jlosses.freespace_loss(outs[..., 3], trunc, fs_mask)
        deltas = gt_dist[:, None] - dists
        ts_mask = (jnp.abs(deltas) < trunc) & hit[:, None]
        l_ts = jlosses.tsdf_loss(outs[..., 3], deltas, trunc, ts_mask)
        return l_ph + l_d + 40.0 * l_fs + 50.0 * l_ts

    want, want_g = jax.value_and_grad(jloss)(params)
    tparams = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
    got, _, _ = ex.ray_losses(
        fset, tparams, cam, torch.from_numpy(np.array(ijs)), torch.from_numpy(_stratified_draws(k2, (r,), s)),
        torch.tensor([ex.SPHERE_CENTER]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    got.backward()
    assert_close(want, got, atol=0.0, rtol=1e-5)
    for k, g in want_g.items():
        g = np.asarray(g)
        assert_close(g, tparams[k].grad, atol=1e-4 * float(np.abs(g).max()), err_msg=k)


def test_fit_synthetic_runs_on_the_cpu():
    """A short fit on the CPU lowers its loss; the tiled KNN route equals
    the field-parallel one inside the field."""
    from neural_graph_mapping_tpu_torch.examples import fit_synthetic as ex

    out = ex.main(iters=12, device="cpu", log_every=0)
    assert len(out["losses"]) == 13 and all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-3:]) < out["losses"][0]
    assert out["knn_points_inside"] > 0 and out["knn_vs_vmap_max_diff"] <= 1e-5
    assert np.isfinite(out["depth_l1_cm"]) and 0.0 <= out["term_prob"] <= 1.0
