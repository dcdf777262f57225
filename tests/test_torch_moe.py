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


# -- the MLP epilogue (``mlp=``) and apply_knn_tiled's choice of it -------------


def _field(**overrides):
    from neural_graph_mapping_tpu_torch.models.fields import NeuralField

    kw = dict(encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
              encoding_kwargs=POW2, num_layers=1, dim_out=4)
    kw.update(overrides)
    return NeuralField(**kw)


@pytest.mark.parametrize("entry", ["rays", "carried"])
def test_moe_mlp_plain_route_equals_encode_then_mlp_fm(entry):
    """With ``mlp=`` a CPU tensor takes the plain encode, then the field MLP
    of each tile's field: NeuralField.mlp_fm's result on the gathered
    weights, bit for bit; dead tiles stay NaN."""
    field = _field()
    params = field.init(N, torch.Generator().manual_seed(5))
    mlp = tuple(params[k] for k in ("w0", "b0", "w1", "b1"))
    tables = torch.from_numpy(_tables(6))
    experts = torch.tensor([1, 1, 2, 0], dtype=torch.int32)
    consts = _consts(POW2)
    live = torch.tensor(LIVE, dtype=torch.int32)
    if entry == "rays":
        kern_orig, dist, poses, ray_params, ctx = _ray_inputs(7)
        args = (tables, torch.from_numpy(kern_orig), torch.from_numpy(dist), experts,
                torch.from_numpy(ray_params), torch.from_numpy(poses), ctx.pop("block_offset"), *consts)
        got = permuto_cuda.encode_fwd_moe_rays(*args, **ctx, num_live_tiles=live, mlp=mlp)
        feats = permuto_cuda.encode_fwd_moe_rays_plain(*args, **ctx, num_live_tiles=live)
    else:
        coords = torch.from_numpy(np.random.default_rng(8).uniform(-0.2, 1.2, (TILES, 3, TILE)).astype(np.float32))
        got = permuto_cuda.encode_fwd_moe(tables, coords, experts, *consts, num_live_tiles=live, mlp=mlp)
        feats = permuto_cuda.encode_fwd_moe_plain(tables, coords, experts, *consts, num_live_tiles=live)
    te = experts.long()
    want = field.mlp_fm({k: v[te] for k, v in params.items() if not k.startswith("enc.")}, feats)
    assert got.shape == (TILES, 4, TILE)
    assert torch.equal(got[:LIVE], want[:LIVE])
    assert torch.isnan(got[LIVE:]).all()
    with pytest.raises(ValueError):  # b1 of the wrong width
        permuto_cuda.encode_fwd_moe(tables, torch.zeros((TILES, 3, TILE)), experts, *consts,
                                    mlp=mlp[:3] + (torch.zeros((N, 3)),))


FALLBACK_MLPS = {
    "concat": dict(skip_mode="concat"),
    "add": dict(skip_mode="add"),
    "rezero": dict(skip_mode="rezero"),
    "two_layers": dict(num_layers=2),
    "hidden_64": dict(dim_mlp_out=64),
}


@pytest.mark.parametrize("mlp", ["epilogue", *FALLBACK_MLPS])
def test_apply_knn_tiled_takes_mlp_fm_for_other_mlps(monkeypatch, mlp):
    """apply_knn_tiled hands the encode the MLP of one hidden layer with no
    skip at the kernels' widths (its result then equals the mlp_fm route bit
    for bit on the CPU); every other MLP (a skip, two hidden layers, 64
    hidden units) runs as NeuralField.mlp_fm over the tiles."""
    from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet, NeuralField

    field_kwargs = dict(encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
                        encoding_kwargs=POW2, num_layers=1, dim_out=4)
    field_kwargs.update(FALLBACK_MLPS.get(mlp, {}))
    fset = NeuralFieldSet(dim_points=3, field_type=NeuralField, field_kwargs=field_kwargs, num_knn=2,
                          distance_factor=10.0, outside_value=1.0, field_radius=1.0, scale_mode="unit_cube")
    gen = torch.Generator().manual_seed(9)
    params = fset.init_fields(6, gen, "cpu")
    if "rezero" in params:
        params["rezero"] = torch.full_like(params["rezero"], 0.5)
    pos = torch.randn((6, 3), generator=gen)
    q = torch.randn((6, 4), generator=gen)
    quat = q / q.norm(dim=-1, keepdim=True)
    valid = torch.ones(6, dtype=torch.bool)
    pts = torch.randn((700, 3), generator=gen)
    calls = {"mlp_fm": 0, "mlp": []}
    real_fm, real_enc = NeuralField.mlp_fm, permuto_cuda.encode_fwd_moe

    def mlp_fm(self, *a, **kw):
        calls["mlp_fm"] += 1
        return real_fm(self, *a, **kw)

    def encode(*a, **kw):
        calls["mlp"].append(kw.get("mlp") is not None)
        return real_enc(*a, **kw)

    monkeypatch.setattr(NeuralField, "mlp_fm", mlp_fm)
    monkeypatch.setattr(permuto_cuda, "encode_fwd_moe", encode)
    got = fset.apply_knn_tiled(params, pts, pos, quat, valid)
    fused = mlp == "epilogue"
    assert calls == {"mlp_fm": 0 if fused else 1, "mlp": [fused]}
    assert (fset._mlp_epilogue(params) is not None) == fused
    monkeypatch.setattr(fset, "_mlp_epilogue", lambda p: None)
    want = fset.apply_knn_tiled(params, pts, pos, quat, valid)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
