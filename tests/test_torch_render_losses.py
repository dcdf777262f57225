"""Parity of the port's quadrature, losses and ray-distance sampling with the
JAX package (the sampling on JAX's own replayed draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch

from neural_graph_mapping_tpu.mapping import render as jrender
from neural_graph_mapping_tpu.ops import losses as jlosses
from neural_graph_mapping_tpu.ops import quadrature as jquad
from neural_graph_mapping_tpu_torch.mapping import render
from neural_graph_mapping_tpu_torch.ops import losses, quadrature


def _samples(seed, f=3, r=16, s=12):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0, 1, (f, 3, r, s)).astype(np.float32)
    geoms = rng.normal(0, 0.3, (f, r, s)).astype(np.float32)
    dists = np.sort(rng.uniform(0.1, 3.0, (f, r, s)), axis=-1).astype(np.float32)
    depths = (dists * rng.uniform(0.8, 1.0, (f, r, 1))).astype(np.float32)
    isds = rng.uniform(0.5, 2.0, (f, 1, 1)).astype(np.float32)
    return colors, geoms, dists, depths, isds


@pytest.mark.parametrize("mode", ["density", "occupancy", "neus", "nrgbd"])
def test_quadrature_fm(mode):
    """All outputs within 1e-5 relative to their scale (f32 sums over 12
    samples)."""
    colors, geoms, dists, depths, isds = _samples(0)
    want = jquad.quadrature_fm(
        mode, *(jnp.asarray(a) for a in (colors, geoms, dists, depths)),
        geometry_factor=20.0, neus_isds=jnp.asarray(isds),
    )
    got = quadrature.quadrature_fm(
        mode, *(torch.from_numpy(a) for a in (colors, geoms, dists, depths)),
        geometry_factor=20.0, neus_isds=torch.from_numpy(isds),
    )
    for name in want._fields:
        assert_close(getattr(want, name), getattr(got, name), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["l1", "l2", "gaussian_nll"])
def test_photometric_loss(mode):
    rng = np.random.default_rng(1)
    meas = rng.uniform(0, 1, (4, 32, 3)).astype(np.float32)
    rend = rng.uniform(0, 1, (4, 32, 3)).astype(np.float32)
    var = rng.uniform(0.01, 0.5, (4, 32, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 32)) < 0.6
    want = jlosses.photometric_loss(mode, *(jnp.asarray(a) for a in (meas, rend, var, mask)))
    got = losses.photometric_loss(mode, *(torch.from_numpy(a) for a in (meas, rend, var, mask)))
    assert_close(want, got, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mode", ["huber", "gaussian_nll", "laplacian_nll"])
def test_depth_loss(mode):
    rng = np.random.default_rng(2)
    meas = rng.uniform(0.5, 3, (4, 32)).astype(np.float32)
    rend = (meas + rng.normal(0, 0.1, (4, 32))).astype(np.float32)
    var = rng.uniform(0.01, 0.5, (4, 32)).astype(np.float32)
    mask = rng.uniform(size=(4, 32)) < 0.6
    want = jlosses.depth_loss(mode, *(jnp.asarray(a) for a in (meas, rend, var, mask)))
    got = losses.depth_loss(mode, *(torch.from_numpy(a) for a in (meas, rend, var, mask)))
    assert_close(want, got, atol=1e-6, rtol=1e-5)


def test_sample_losses_and_empty_mask():
    rng = np.random.default_rng(3)
    geoms = rng.normal(0, 1, (4, 32, 10)).astype(np.float32)
    deltas = rng.normal(0, 0.1, (4, 32, 10)).astype(np.float32)
    mask = rng.uniform(size=(4, 32, 10)) < 0.5
    pred_t = rng.uniform(0, 1, (4, 32)).astype(np.float32)
    tgt_t = (rng.uniform(size=(4, 32)) < 0.5).astype(np.float32)
    t_mask = rng.uniform(size=(4, 32)) < 0.5
    pairs = [
        (jlosses.freespace_loss(jnp.asarray(geoms), 0.1, jnp.asarray(mask)),
         losses.freespace_loss(torch.from_numpy(geoms), 0.1, torch.from_numpy(mask))),
        (jlosses.tsdf_loss(jnp.asarray(geoms), jnp.asarray(deltas), 0.1, jnp.asarray(mask)),
         losses.tsdf_loss(torch.from_numpy(geoms), torch.from_numpy(deltas), 0.1, torch.from_numpy(mask))),
        (jlosses.termination_loss(jnp.asarray(pred_t), jnp.asarray(tgt_t), jnp.asarray(t_mask)),
         losses.termination_loss(torch.from_numpy(pred_t), torch.from_numpy(tgt_t), torch.from_numpy(t_mask))),
    ]
    for want, got in pairs:
        assert_close(want, got, atol=1e-7, rtol=1e-5)
    empty = np.zeros((4, 32, 10), bool)
    assert float(losses.masked_mean(torch.from_numpy(geoms), torch.from_numpy(empty))) == 0.0


def test_sample_ray_distances_on_replayed_draws():
    """Stratified coarse + depth-guided distances, from JAX's own uniforms
    (same key, same split order), within 1e-6."""
    cfg = jrender.RenderConfig(num_samples_coarse=8, num_samples_depth_guided=16,
                               range_depth_guided=0.1)
    tcfg = render.RenderConfig(**cfg._asdict())
    rng = np.random.default_rng(4)
    f, r = 3, 20
    near = rng.uniform(0, 1, (f, r)).astype(np.float32)
    far = (near + rng.uniform(0.5, 2, (f, r))).astype(np.float32)
    gt = (near + rng.uniform(-0.2, 2.5, (f, r))).astype(np.float32)
    gt[0, :5] = 0.0  # no depth: guided samples fall back to near/far
    key = jax.random.PRNGKey(11)
    want = jrender.sample_ray_distances(key, jnp.asarray(near), jnp.asarray(far), jnp.asarray(gt), cfg)
    k1, k2 = jax.random.split(key)
    u_coarse = jax.random.uniform(k1, (f, r, 8))
    u_guided = jax.random.uniform(k2, (f, r, 16))
    got = render.sample_ray_distances(
        torch.from_numpy(near), torch.from_numpy(far), torch.from_numpy(gt), tcfg,
        to_torch(u_coarse), to_torch(u_guided),
    )
    assert got.shape == (f, r, 24)
    assert_close(want, got, atol=1e-6)
    assert (np.diff(to_np(got), axis=-1) >= 0).all()
