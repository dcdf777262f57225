"""The port's MoE encodes of the render path (ops/permuto_cuda.py
``encode_fwd_moe`` and ``encode_fwd_moe_rays``, the plain versions a CPU
tensor takes) against the JAX package's Pallas kernels in interpret mode
with f32 tables (``mxu_dtype=float32``; the default bf16 route packs them).

Tolerances: the Pallas lattice multiplies by 1/scale where the port divides
by the scale. With power-of-two scales the two are the same operation, and
the encodes agree within 1e-5 (tables U(-1, 1)); at other scales a
coordinate may differ by an ulp, and they agree within 1e-4, as in
tests/test_torch_permuto.py. Only live tiles are compared: the kernels never
write the others, and the port's plain version fills them with NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np

from neural_graph_mapping_tpu.ops import permuto as jpermuto
from neural_graph_mapping_tpu.ops import permuto_pallas
from neural_graph_mapping_tpu.ops.encodings import PermutohedralEncoding as JaxEncoding
from neural_graph_mapping_tpu_torch.ops import permuto_cuda

POW2 = dict(pos_dim=3, log2_hashmap_size=7, nr_levels=3, nr_feat_per_level=2,
            coarsest_scale=1.0, finest_scale=0.25, init_scale=1e-2)  # scales 1, 1/2, 1/4
GENERIC = dict(POW2, finest_scale=0.05)
MIXED_CAPS = (64, 128, 128)
N, TILES, LIVE = 5, 4, 3
TILE = permuto_cuda.TILE


def _consts(kwargs, caps=MIXED_CAPS):
    enc = JaxEncoding(**kwargs)
    return (enc._scales_t, enc._shifts_t, enc._elev_t, caps)


def _tables(seed, shape=(N, 2, 3, 128)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _live(x):
    return np.asarray(x)[:LIVE]


@pytest.mark.parametrize("kwargs,atol", [(POW2, 1e-5), (GENERIC, 1e-4)], ids=["pow2", "generic"])
def test_encode_fwd_moe_plain_matches_pallas(kwargs, atol):
    rng = np.random.default_rng(0)
    tables = _tables(1)
    coords = rng.uniform(-0.2, 1.2, (TILES, 3, TILE)).astype(np.float32)
    experts = np.array([0, 3, 3, 4], np.int32)
    consts = _consts(kwargs)
    want = permuto_pallas.encode_fwd_moe(
        jnp.asarray(tables), jnp.asarray(coords), jnp.asarray(experts), *consts,
        num_live_tiles=jnp.int32(LIVE), interpret=True, mxu_dtype=jnp.float32,
    )
    got = permuto_cuda.encode_fwd_moe(
        torch.from_numpy(tables), torch.from_numpy(coords), torch.from_numpy(experts), *consts,
        num_live_tiles=torch.tensor(LIVE, dtype=torch.int32),
    )
    assert got.shape == (TILES, 6, TILE)
    assert_close(_live(want), _live(to_np(got)), atol=atol)
    assert torch.isnan(got[LIVE:]).all()


def _ray_inputs(seed, k=2, rays=64, samples=32, width=16):
    """Tiles of k-major pairs of a 16-wide image's rows from a non-zero
    block offset, re-indexed k-minor as apply_knn_tiled hands them to the
    ray kernel; rotated field poses and camera."""
    rng = np.random.default_rng(seed)
    p = rays * samples
    orig = rng.permutation(TILES * TILE) % (p * k)  # k-major pair indices
    kern_orig = ((orig % p) * k + orig // p).astype(np.int32).reshape(TILES, TILE)
    dist = rng.uniform(0.5, 4.0, (TILES, TILE)).astype(np.float32)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(N, 3)).astype(np.float32), q], axis=-1)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot *= np.sign(np.linalg.det(rot))  # a proper rotation
    fx, fy, cx, cy = 14.0, 15.0, 8.0, 6.0
    ray_params = np.concatenate(
        [rot.reshape(-1), [0.3, -0.2, 3.0], np.asarray([1.0 / fx, 1.0 / fy, cx, cy], np.float32)]
    ).astype(np.float32)
    ctx = dict(block_offset=48, log2_ks=int(np.log2(k * samples)), width=width,
               coord_scale=0.5, coord_shift=0.5)
    return kern_orig, dist, poses, ray_params, ctx


@pytest.mark.parametrize("kwargs,atol", [(POW2, 1e-5), (GENERIC, 1e-4)], ids=["pow2", "generic"])
def test_encode_fwd_moe_rays_plain_matches_pallas(kwargs, atol):
    """The in-kernel point rebuild (pair -> ray -> pixel -> direction ->
    world -> rotated field-local point) and the encode, against JAX's."""
    kern_orig, dist, poses, ray_params, ctx = _ray_inputs(2)
    tables = _tables(3)
    experts = np.array([1, 1, 2, 0], np.int32)
    consts = _consts(kwargs)
    want = permuto_pallas.encode_fwd_moe_rays(
        jnp.asarray(tables), jnp.asarray(kern_orig), jnp.asarray(dist), jnp.asarray(experts),
        jnp.asarray(ray_params), jnp.asarray(poses), jnp.int32(ctx["block_offset"]), *consts,
        log2_ks=ctx["log2_ks"], width=ctx["width"], coord_scale=ctx["coord_scale"],
        coord_shift=ctx["coord_shift"], num_live_tiles=jnp.int32(LIVE), interpret=True,
        mxu_dtype=jnp.float32,
    )
    got = permuto_cuda.encode_fwd_moe_rays(
        torch.from_numpy(tables), torch.from_numpy(kern_orig), torch.from_numpy(dist),
        torch.from_numpy(experts), torch.from_numpy(ray_params), torch.from_numpy(poses),
        ctx["block_offset"], *consts, log2_ks=ctx["log2_ks"], width=ctx["width"],
        coord_scale=ctx["coord_scale"], coord_shift=ctx["coord_shift"],
        num_live_tiles=torch.tensor(LIVE, dtype=torch.int32),
    )
    assert_close(_live(want), _live(to_np(got)), atol=atol)
    assert torch.isnan(got[LIVE:]).all()
    # a wrong block offset moves the points: the rebuild is live
    other = permuto_cuda.encode_fwd_moe_rays(
        torch.from_numpy(tables), torch.from_numpy(kern_orig), torch.from_numpy(dist),
        torch.from_numpy(experts), torch.from_numpy(ray_params), torch.from_numpy(poses),
        ctx["block_offset"] + 16, *consts, log2_ks=ctx["log2_ks"], width=ctx["width"],
        coord_scale=ctx["coord_scale"], coord_shift=ctx["coord_shift"],
    )
    assert float((other[:LIVE] - got[:LIVE]).abs().max()) > 1e-3


def test_encode_fwd_moe_at_production_capacities():
    """Production lattice (16 levels, capacities 512, 1024, 4096, ...) per
    tile against the JAX CPU encode (lattice + gather_blend) of the tile's
    field: same corners, within 1e-6."""
    kwargs = dict(pos_dim=3, log2_hashmap_size=12, nr_levels=16, nr_feat_per_level=2,
                  coarsest_scale=1.0, finest_scale=1e-4, init_scale=1e-5)
    enc = JaxEncoding(**kwargs)
    rng = np.random.default_rng(4)
    tables = rng.uniform(-1, 1, (3, 2, 16, 4096)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (2, 3, TILE)).astype(np.float32)
    experts = np.array([2, 0], np.int32)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    got = permuto_cuda.encode_fwd_moe(
        torch.from_numpy(tables), torch.from_numpy(coords), torch.from_numpy(experts), *consts
    )
    for t, e in enumerate(experts):
        idx, w = jpermuto.lattice_keys_and_weights_soa(
            tuple(jnp.asarray(c) for c in coords[t]), jnp.asarray(enc.scales), enc._shifts,
            enc._elev_scale, enc.level_capacities,
        )
        want = jpermuto.gather_blend(jnp.asarray(tables[e]), idx, w)
        assert_close(want, got[t], atol=1e-6)


def test_moe_wrappers_reject_bad_inputs():
    consts = _consts(POW2)
    tables = torch.zeros((N, 2, 3, 128))
    coords = torch.zeros((2, 3, TILE))
    with pytest.raises(TypeError):  # tile_experts must be int32
        permuto_cuda.encode_fwd_moe(tables, coords, torch.zeros(2, dtype=torch.int64), *consts)
    with pytest.raises(ValueError):
        permuto_cuda.encode_fwd_moe(tables, torch.zeros((2, 3, 100)), torch.zeros(2, dtype=torch.int32), *consts)
    with pytest.raises(ValueError):
        permuto_cuda.encode_fwd_moe(tables[:, :, :, :32].contiguous(), coords,
                                    torch.zeros(2, dtype=torch.int32), *consts)
    with pytest.raises(TypeError):
        permuto_cuda.encode_fwd_moe_rays(
            tables, torch.zeros((2, TILE), dtype=torch.int64), torch.zeros((2, TILE)),
            torch.zeros(2, dtype=torch.int32), torch.zeros(16), torch.zeros((N, 7)), 0, *consts,
            log2_ks=6, width=16, coord_scale=0.5, coord_shift=0.5,
        )
    before = dict(permuto_cuda.LAUNCHES)
    permuto_cuda.encode_fwd_moe(tables, coords, torch.zeros(2, dtype=torch.int32), *consts)
    assert permuto_cuda.LAUNCHES == before  # the plain version is no launch
