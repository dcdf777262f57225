"""Parity of the port's permutohedral encoding core with the JAX package.

The port's lattice must pick the same corners (indices exact) with the same
weights as ``permuto.lattice_keys_and_weights_soa``, at the production
constants and per-level capacities (512, 1024, 4096, ...), whose short coarse
levels exercise the per-level hash masks. The plain encode and table
gradient (what the CUDA kernels are held against on the card) must match
the JAX CPU path and the Pallas kernels run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np, to_torch

from neural_graph_mapping_tpu.ops import permuto as jpermuto
from neural_graph_mapping_tpu.ops import permuto_pallas
from neural_graph_mapping_tpu.ops.encodings import PermutohedralEncoding as JaxEncoding
from neural_graph_mapping_tpu_torch.ops import permuto, permuto_cuda
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

PRODUCTION = dict(
    pos_dim=3, log2_hashmap_size=12, nr_levels=16, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=1e-4, init_scale=1e-5,
)
SMALL = dict(
    pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2,
)


def _points(n, seed, grid=True):
    """Random field-local points plus (optionally) a coarse grid of exactly
    representable coordinates, which lands points on rounding ties."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 1.5, (3, n)).astype(np.float32)
    if grid:
        g = np.arange(-4, 13, dtype=np.float32) / 8.0
        gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
        pts = np.concatenate([pts, np.stack([gx, gy, gz]).reshape(3, -1)], axis=1)
    return pts


def _consts(enc):
    return (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)


@pytest.fixture(scope="module")
def production():
    return JaxEncoding(**PRODUCTION), PermutohedralEncoding(**PRODUCTION)


def test_production_capacities(production):
    je, te = production
    assert te.level_capacities == je.level_capacities
    assert te.level_capacities[:3] == (512, 1024, 4096)
    assert set(te.level_capacities[2:]) == {4096}


def test_lattice_matches_jax_at_production_constants(production):
    """Indices exact, weights within 1e-6: 2k random and 4913 grid points,
    and 30,720 points built to sit on each level's rounding boundaries
    (``chip_smoke.lattice_boundary_points``, which the card's lattice is
    held to as well), where a corner swap has near-zero weight."""
    import chip_smoke

    je, te = production
    boundary = chip_smoke.lattice_boundary_points(te._scales_t, te._shifts_t, te._elev_t)
    pts = np.concatenate([_points(2000, 0), boundary], axis=1)
    want_idx, want_w = jpermuto.lattice_keys_and_weights_soa(
        tuple(jnp.asarray(p) for p in pts), jnp.asarray(je.scales), je._shifts,
        je._elev_scale, je.level_capacities,
    )
    got_idx, got_w = permuto.lattice_keys_and_weights_soa(
        tuple(torch.from_numpy(p) for p in pts), te.scales, te.shifts, te.elev_scale,
        te.level_capacities,
    )
    np.testing.assert_array_equal(to_np(got_idx), np.asarray(want_idx))
    assert_close(want_w, got_w, atol=1e-6)
    # every level stays inside its own capacity
    caps = np.asarray(te.level_capacities)[:, None, None]
    assert (to_np(got_idx) < caps).all()


def test_hash_multiply_wraps_like_uint32():
    keys = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789], dtype=np.uint64)
    for prime in permuto.HASH_PRIMES:
        want = (keys.astype(np.uint32) * np.uint32(prime)).astype(np.int64)
        got = permuto._mul_u32(torch.from_numpy(keys.astype(np.int64)), prime).numpy()
        np.testing.assert_array_equal(got, want)


def test_plain_encode_matches_gather_blend(production):
    """The plain encode (encode_fwd on a CPU tensor) vs the JAX CPU encode,
    within 1e-6, tables U(-1, 1)."""
    je, te = production
    rng = np.random.default_rng(1)
    pts = _points(2000, 1, grid=False)
    table = rng.uniform(-1, 1, (2, 16, 4096)).astype(np.float32)
    idx, w = jpermuto.lattice_keys_and_weights_soa(
        tuple(jnp.asarray(p) for p in pts), jnp.asarray(je.scales), je._shifts,
        je._elev_scale, je.level_capacities,
    )
    want = jpermuto.gather_blend(jnp.asarray(table), idx, w)
    got = permuto_cuda.encode_fwd(torch.from_numpy(table), torch.from_numpy(pts), *_consts(te))
    assert got.shape == (32, pts.shape[1])
    assert_close(want, got, atol=1e-6)


def test_plain_table_grad_matches_vjp(production):
    """The plain table gradient (encode_bwd_table on CPU) vs jax.vjp of
    gather_blend, within 1e-5."""
    je, te = production
    rng = np.random.default_rng(2)
    pts = _points(2000, 2, grid=False)
    table = rng.uniform(-1, 1, (2, 16, 4096)).astype(np.float32)
    g = rng.normal(size=(32, pts.shape[1])).astype(np.float32)
    idx, w = jpermuto.lattice_keys_and_weights_soa(
        tuple(jnp.asarray(p) for p in pts), jnp.asarray(je.scales), je._shifts,
        je._elev_scale, je.level_capacities,
    )
    _, vjp = jax.vjp(lambda t: jpermuto.gather_blend(t, idx, w), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    got = permuto_cuda.encode_bwd_table(torch.from_numpy(pts), torch.from_numpy(g), *_consts(te))
    assert got.shape == (2, 16, 4096)
    assert_close(want, got, atol=1e-5)


def test_table_grad_fallback_matches_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 256, (4, 4, 300))
    gv = rng.normal(size=(4, 2, 4 * 300)).astype(np.float32)
    want = jpermuto._table_grad_fallback(jnp.asarray(idx, jnp.int32), jnp.asarray(gv), 256)
    got = permuto._table_grad_fallback(torch.from_numpy(idx), torch.from_numpy(gv), 256)
    assert_close(want, got, atol=1e-5)


def test_gather_blend_and_weight_grads_match_jax():
    """gather_blend (plain, autograd) features and its weight gradient."""
    je, te = JaxEncoding(**SMALL), PermutohedralEncoding(**SMALL)
    rng = np.random.default_rng(4)
    pts = _points(500, 4, grid=False)
    table = rng.uniform(-1, 1, (2, 4, 256)).astype(np.float32)
    g = rng.normal(size=(8, 500)).astype(np.float32)
    idx, w = jpermuto.lattice_keys_and_weights_soa(
        tuple(jnp.asarray(p) for p in pts), jnp.asarray(je.scales), je._shifts,
        je._elev_scale, je.level_capacities,
    )
    want, vjp = jax.vjp(lambda t, ww: jpermuto.gather_blend(t, idx, ww), jnp.asarray(table), w)
    want_gt, want_gw = vjp(jnp.asarray(g))
    t_table = torch.from_numpy(table).requires_grad_(True)
    t_w = to_torch(w).requires_grad_(True)
    got = permuto.gather_blend(t_table, to_torch(idx).long(), t_w)
    got.backward(torch.from_numpy(g))
    assert_close(want, got, atol=1e-6)
    assert_close(want_gt, t_table.grad, atol=1e-5)
    assert_close(want_gw, t_w.grad, atol=1e-5)


@pytest.mark.parametrize(
    "caps", [(256, 256, 256, 256), (128, 256, 256, 256)], ids=["uniform", "mixed"]
)
def test_plain_versions_match_pallas_interpret(caps):
    """encode_fwd / encode_bwd_table plain versions vs the Pallas kernels in
    interpret mode with f32 MXU operands, including mixed capacities (the
    short-level branch). The Pallas lattice multiplies by 1/scale where the
    CPU path divides, so it agrees to the tolerance the JAX package's own
    tests/test_permuto_pallas.py holds it to against that path (forward
    atol 1e-4; table gradient atol 1e-3, rtol 1e-4), not bit for bit."""
    te = PermutohedralEncoding(**SMALL)
    rng = np.random.default_rng(5)
    b, p = 2, 700
    table = rng.uniform(-1, 1, (b, 2, 4, 256)).astype(np.float32)
    coords = rng.uniform(-0.5, 1.5, (b, 3, p)).astype(np.float32)
    g = rng.normal(size=(b, 8, p)).astype(np.float32)
    consts = (te._scales_t, te._shifts_t, te._elev_t, caps)
    want = permuto_pallas.encode_fwd(
        jnp.asarray(table), jnp.asarray(coords), *consts, interpret=True,
        mxu_dtype=jnp.float32,
    )
    got = permuto_cuda.encode_fwd(torch.from_numpy(table), torch.from_numpy(coords), *consts)
    assert_close(want, got, atol=1e-4)
    want_g = permuto_pallas.encode_bwd_table(
        jnp.asarray(coords), jnp.asarray(g), *consts, interpret=True, mxu_dtype=jnp.float32
    )
    got_g = permuto_cuda.encode_bwd_table(torch.from_numpy(coords), torch.from_numpy(g), *consts)
    assert got_g.shape == (b, 2, 4, 256)
    assert_close(want_g, got_g, atol=1e-3, rtol=1e-4)
    # the short level's gradient lives in its first 128 entries only
    if caps[0] == 128:
        assert float(got_g[:, :, 0, 128:].abs().max()) == 0.0


@pytest.mark.parametrize("spread", [1e-3, 0.05], ids=["one_coarse_cell", "few_coarse_cells"])
def test_plain_table_grad_matches_pallas_when_points_share_cells(spread):
    """Every point of a field within ``spread`` of one spot: on the coarse
    levels all of them add into the same few entries (the contention the
    CUDA kernel aggregates within a warp). The plain table gradient against
    the Pallas kernel in interpret mode, at its tolerance (see above)."""
    te = PermutohedralEncoding(**SMALL)
    rng = np.random.default_rng(7)
    b, p = 2, 1000
    coords = (0.37 + rng.uniform(0, spread, (b, 3, p))).astype(np.float32)
    g = rng.normal(size=(b, 8, p)).astype(np.float32)
    consts = _consts(te)
    want = permuto_pallas.encode_bwd_table(
        jnp.asarray(coords), jnp.asarray(g), *consts, interpret=True, mxu_dtype=jnp.float32
    )
    got = permuto_cuda.encode_bwd_table(torch.from_numpy(coords), torch.from_numpy(g), *consts)
    assert_close(want, got, atol=1e-3, rtol=1e-4)
    # the coarsest level of each field: every point in a handful of entries
    assert max(int(torch.count_nonzero(got[i, 0, 0])) for i in range(b)) <= 8
    # barycentric weights sum to 1: each level's gradient sums to its cotangent
    g_sum = torch.from_numpy(g.reshape(b, 4, 2, p).sum(-1)).transpose(1, 2)
    torch.testing.assert_close(got.sum(-1), g_sum, rtol=1e-4, atol=1e-3)


def test_plain_table_grad_matches_pallas_at_production_capacities(production):
    """The production capacity tuple (512, 1024, 4096 x 14) on one
    1024-point tile: the plain table gradient against the Pallas kernel in
    interpret mode, and exactly zero past each level's capacity. The scales
    run down to 0.01, the finest the JAX package's own Pallas tests use: at
    1e-4 the Pallas lattice's multiply by 1/scale picks other corners than
    the CPU path's division for some points."""
    _, te = production
    coarse = PermutohedralEncoding(**dict(PRODUCTION, finest_scale=0.01))
    rng = np.random.default_rng(8)
    coords = rng.uniform(-0.25, 1.25, (1, 3, 1024)).astype(np.float32)
    g = rng.normal(size=(1, 32, 1024)).astype(np.float32)
    consts = (coarse._scales_t, coarse._shifts_t, coarse._elev_t, te.level_capacities)
    want = permuto_pallas.encode_bwd_table(
        jnp.asarray(coords), jnp.asarray(g), *consts, interpret=True, mxu_dtype=jnp.float32
    )
    got = permuto_cuda.encode_bwd_table(torch.from_numpy(coords), torch.from_numpy(g), *consts)
    assert got.shape == (1, 2, 16, 4096)
    assert_close(want, got, atol=1e-3, rtol=1e-4)
    for level, cap in enumerate(te.level_capacities):
        assert float(got[..., level, cap:].abs().sum()) == 0.0
        assert float(np.abs(np.asarray(want)[..., level, cap:]).sum()) == 0.0


def test_encode_fused_returns_zero_coordinate_gradient():
    te = PermutohedralEncoding(**SMALL)
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.uniform(-1, 1, (3, 2, 4, 256)).astype(np.float32))
    table.requires_grad_(True)
    coords = torch.from_numpy(rng.uniform(-0.5, 1.5, (3, 3, 400)).astype(np.float32))
    coords.requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(3, 8, 400)).astype(np.float32))
    out = permuto.encode_fused(table, coords, *_consts(te))
    out.backward(g)
    assert torch.count_nonzero(coords.grad) == 0
    want = permuto_cuda.encode_bwd_table(coords.detach(), g, *_consts(te))
    torch.testing.assert_close(table.grad, want, rtol=0, atol=0)
    assert_close(to_np(out), permuto_cuda.encode_fwd(table.detach(), coords.detach(), *_consts(te)), atol=0)


def test_wrappers_reject_bad_inputs():
    te = PermutohedralEncoding(**SMALL)
    table = torch.zeros((2, 4, 256))
    with pytest.raises(TypeError):
        permuto_cuda.encode_fwd(table, torch.zeros((3, 10), dtype=torch.float64), *_consts(te))
    with pytest.raises(ValueError):
        permuto_cuda.encode_fwd(table, torch.zeros((4, 10)), *_consts(te))
    with pytest.raises(ValueError):
        permuto_cuda.encode_fwd(table[:, :, :128].contiguous(), torch.zeros((3, 10)), *_consts(te))
    with pytest.raises(ValueError):
        permuto_cuda.encode_bwd_table(torch.zeros((3, 10)), torch.zeros((7, 10)), *_consts(te))
    # plain-version calls are not kernel launches
    before = dict(permuto_cuda.LAUNCHES)
    permuto_cuda.encode_fwd(table, torch.zeros((3, 10)), *_consts(te))
    assert permuto_cuda.LAUNCHES == before
