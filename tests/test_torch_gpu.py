"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (the kernels
have no CPU mode). Run them on a GPU machine with
``python -m pytest tests/test_torch_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from neural_graph_mapping_tpu_torch.ops import cuda_build, dispatch, permuto, permuto_cuda, topk
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

pytestmark = pytest.mark.gpu

PRODUCTION = dict(
    pos_dim=3, log2_hashmap_size=12, nr_levels=16, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=1e-4, init_scale=1e-5,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, p, seed):
    enc = PermutohedralEncoding(**PRODUCTION)
    gen = torch.Generator(dev).manual_seed(seed)
    table = torch.rand((b, 2, 16, 4096), generator=gen, device=dev) * 2 - 1
    coords = torch.rand((b, 3, p), generator=gen, device=dev) * 1.5 - 0.25
    g = torch.randn((b, 32, p), generator=gen, device=dev)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    return table, coords, g, consts


@pytest.mark.parametrize("b,p", [(1, 1), (3, 1000), (32, 12288)])
def test_encode_fwd_matches_plain(cuda, b, p):
    """Same corners as the plain version (built without FMA contraction):
    max abs difference <= 1e-5 with tables U(-1, 1)."""
    table, coords, _, consts = _inputs(cuda, b, p, 0)
    before = permuto_cuda.LAUNCHES["encode_fwd"]
    got = permuto_cuda.encode_fwd(table, coords, *consts)
    assert permuto_cuda.LAUNCHES["encode_fwd"] == before + 1
    want = permuto_cuda.encode_fwd_plain(table, coords, *consts)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("b,p", [(3, 1000), (32, 12288)])
def test_encode_bwd_table_matches_plain(cuda, b, p):
    """Atomics change the summation order: max abs <= 1e-4 * max|plain|."""
    _, coords, g, consts = _inputs(cuda, b, p, 1)
    got = permuto_cuda.encode_bwd_table(coords, g, *consts)
    want = permuto_cuda.encode_bwd_table_plain(coords, g, *consts, 4096)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("b,n,m", [
    (1000, 19200, 640),  # the main path's shape: 16-byte groups of four lookups
    (1000, 19200, 641),  # M % 4 != 0: the scalar variant, a short last group
    (7, 100, 1),
    (70_000, 64, 5),  # more slots than gridDim.y holds: the slot loop
])
def test_batched_gather_exact(cuda, b, n, m):
    gen = torch.Generator(cuda).manual_seed(2)
    values = torch.rand((b, n), generator=gen, device=cuda)
    idx = torch.randint(0, n, (b, m), generator=gen, device=cuda)
    assert torch.equal(permuto_cuda.batched_gather(values, idx), torch.gather(values, 1, idx))


def test_encode_fused_autograd_on_card(cuda):
    table, coords, g, consts = _inputs(cuda, 4, 777, 3)
    table.requires_grad_(True)
    coords.requires_grad_(True)
    out = permuto.encode_fused(table, coords, *consts)
    out.backward(g)
    torch.cuda.synchronize()
    assert torch.count_nonzero(coords.grad) == 0
    want = permuto_cuda.encode_bwd_table_plain(coords.detach(), g, *consts, 4096)
    assert float((table.grad - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_cuda_tensors_never_take_the_plain_path(cuda):
    """Mixed devices raise instead of falling back."""
    table, coords, _, consts = _inputs(cuda, 1, 10, 4)
    with pytest.raises(ValueError):
        permuto_cuda.encode_fwd(table, coords.cpu(), *consts)
    with pytest.raises(ValueError):
        permuto_cuda.batched_gather(torch.zeros((1, 4), device=cuda), torch.zeros((1, 2), dtype=torch.int64))
    assert np.isfinite(permuto_cuda.load_library().build_seconds)


@pytest.mark.parametrize("p,n", [(1, 1), (1000, 5), (300_000, 128), (70_000, 2100)])
def test_topk2_fields_matches_plain_exactly(cuda, p, n):
    """Direct-form distances rounded op by op in both: bit-identical,
    including ties (duplicate centres) and invalid centres; N = 2100 spans
    two shared-memory chunks."""
    gen = torch.Generator(cuda).manual_seed(5)
    pts = torch.randn((3, p), generator=gen, device=cuda) * 2
    cen = torch.randn((n, 3), generator=gen, device=cuda) * 2
    valid = torch.rand((n,), generator=gen, device=cuda) > 0.25
    if n > 8:
        cen[7] = cen[3]
        valid[3] = valid[7] = True
    before = topk.LAUNCHES["topk2_fields"]
    d, i = topk.topk2_fields(pts, cen, valid)
    assert topk.LAUNCHES["topk2_fields"] == before + 1
    wd, wi = topk.topk2_fields_plain(pts, cen, valid)
    torch.cuda.synchronize()
    assert torch.equal(d, wd) and torch.equal(i, wi)


def _moe_inputs(dev, tiles, n, seed):
    enc = PermutohedralEncoding(**PRODUCTION)
    gen = torch.Generator(dev).manual_seed(seed)
    tables = torch.rand((n, 2, 16, 4096), generator=gen, device=dev) * 2 - 1
    experts = torch.sort(torch.randint(0, n, (tiles,), generator=gen, device=dev)).values.to(torch.int32)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    return gen, tables, experts, consts


@pytest.mark.parametrize("tiles,n", [(3, 2), (300, 64)])
def test_encode_fwd_moe_matches_plain(cuda, tiles, n):
    gen, tables, experts, consts = _moe_inputs(cuda, tiles, n, 6)
    coords = torch.rand((tiles, 3, 1024), generator=gen, device=cuda) * 1.5 - 0.25
    live = torch.tensor(tiles - 1, dtype=torch.int32, device=cuda)
    got = permuto_cuda.encode_fwd_moe(tables, coords, experts, *consts, num_live_tiles=live)
    want = permuto_cuda.encode_fwd_moe_plain(tables, coords, experts, *consts)
    torch.cuda.synchronize()
    assert float((got[: tiles - 1] - want[: tiles - 1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("tiles,n,width", [(3, 2, 16), (300, 64, 640)])
def test_encode_fwd_moe_rays_matches_plain(cuda, tiles, n, width):
    """Point rebuild with IEEE sqrt and division on both sides: the same
    corners, max abs <= 1e-5."""
    gen, tables, experts, consts = _moe_inputs(cuda, tiles, n, 7)
    orig = torch.randint(0, 8192 * 1024, (tiles, 1024), generator=gen, device=cuda, dtype=torch.int32)
    dist = torch.rand((tiles, 1024), generator=gen, device=cuda) * 4 + 0.5
    q = torch.randn((n, 4), generator=gen, device=cuda)
    poses = torch.cat([torch.randn((n, 3), generator=gen, device=cuda), q / q.norm(dim=-1, keepdim=True)], 1)
    rot = torch.linalg.qr(torch.randn((3, 3), generator=gen, device=cuda))[0]
    rayp = torch.cat([rot.reshape(-1), torch.tensor([0.3, -0.2, 3.0, 1 / 560.0, 1 / 560.0, 320.0, 240.0],
                                                     device=cuda)]).contiguous()
    args = (tables, orig, dist, experts, rayp, poses.contiguous(), 4096, *consts)
    kw = dict(log2_ks=10, width=width, coord_scale=0.5, coord_shift=0.5)
    got = permuto_cuda.encode_fwd_moe_rays(*args, **kw)
    want = permuto_cuda.encode_fwd_moe_rays_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5


def test_dispatch_and_blend_on_card_match_cpu(cuda):
    """apply_knn_tiled on the card (all three render kernels) against the
    same call on the CPU (plain versions): max abs <= 1e-4."""
    from neural_graph_mapping_tpu_torch.models.fields import NeuralFieldSet

    kw = dict(dim_points=3, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
              field_kwargs=dict(encoding_type="neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding",
                                encoding_kwargs=PRODUCTION, num_layers=1, dim_out=4),
              num_knn=2, distance_factor=10.0, outside_value=1.0, field_radius=1.0, scale_mode="unit_cube")
    fset = NeuralFieldSet(**kw).to(cuda)
    gen = torch.Generator(cuda).manual_seed(8)
    params = fset.init_fields(16, gen, cuda)
    params["enc.table"] = params["enc.table"] * 1e4
    pos = torch.randn((16, 3), generator=gen, device=cuda) * 1.5
    q = torch.randn((16, 4), generator=gen, device=cuda)
    quat = q / q.norm(dim=-1, keepdim=True)
    valid = torch.arange(16, device=cuda) < 12
    pts = torch.randn((50_000, 3), generator=gen, device=cuda) * 2
    got = fset.apply_knn_tiled(params, pts, pos, quat, valid)
    cpu = {k: v.cpu() for k, v in params.items()}
    want = NeuralFieldSet(**kw).apply_knn_tiled(cpu, pts.cpu(), pos.cpu(), quat.cpu(), valid.cpu())
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert dispatch.topk_fields(pts[:10], pos, valid, 3)[0].is_cuda
    assert set(cuda_build.load_all()) == set(cuda_build.SOURCES)


# -- the gather route (gather_pairs, table_grad) --------------------------------


@pytest.mark.parametrize("lead,t,m", [((3,), 256, 700), ((2, 4), 128, 300), ((32, 16), 4096, 36864)])
def test_gather_pairs_matches_plain_exactly(cuda, lead, t, m):
    gen = torch.Generator(cuda).manual_seed(9)
    table = torch.randn(lead + (2, t), generator=gen, device=cuda)
    idx = torch.randint(0, t, lead + (m,), generator=gen, device=cuda)
    before = permuto_cuda.LAUNCHES["gather_pairs"]
    got = permuto_cuda.gather_pairs(table, idx)
    assert permuto_cuda.LAUNCHES["gather_pairs"] == before + 1
    assert torch.equal(got, permuto_cuda.gather_pairs_plain(table, idx))


@pytest.mark.parametrize("rows,t,m,offset,variant", [
    (512, 4096, 36864, 0, "staged"),  # the 2D field set's shape
    (3, 4096, 4099, 0, "staged"),  # M % 4 != 0: the scalar variant of the staged kernel
    (4, 12288, 9000, 0, "staged"),  # the largest staged table, 96 KB
    (4, 16384, 1001, 0, "direct"),  # a table above the staged maximum
    (3, 4096, 500, 0, "direct"),  # T >= 8 M: staging would move more bytes than the pairs
    (3, 4096, 36864, 1, "direct"),  # a table 4 bytes off 16-byte alignment: no bulk copy
    (70_000, 16, 7, 0, "staged"),  # more rows than gridDim.y holds (rows on grid x)
    (70_000, 16, 1, 0, "direct"),  # the direct variant's row loop
])
def test_gather_pairs_variants_exact(cuda, rows, t, m, offset, variant):
    gen = torch.Generator(cuda).manual_seed(16)
    storage = torch.randn((offset + rows * 2 * t,), generator=gen, device=cuda)
    table = storage[offset:].view(rows, 2, t)
    idx = torch.randint(0, t, (rows, m), generator=gen, device=cuda)
    assert permuto_cuda.gather_pairs_variant(table, idx) == variant
    assert torch.equal(permuto_cuda.gather_pairs(table, idx), permuto_cuda.gather_pairs_plain(table, idx))


def _wrapper_calls(dev):
    """{wrapper name: a call of it on small CUDA inputs}, all ten kernels."""
    table, coords, g, consts = _inputs(dev, 2, 300, 18)
    gen = torch.Generator(dev).manual_seed(18)
    values = torch.rand((4, 50), generator=gen, device=dev)
    vidx = torch.randint(0, 50, (4, 9), generator=gen, device=dev)
    rows_t = torch.randn((5, 2, 256), generator=gen, device=dev)
    ridx = torch.randint(0, 256, (5, 300), generator=gen, device=dev)
    gv = torch.randn((5, 2, 300), generator=gen, device=dev)
    _, tables, experts, mconsts = _moe_inputs(dev, 3, 2, 18)
    mcoords = torch.rand((3, 3, 1024), generator=gen, device=dev)
    orig = torch.randint(0, 1 << 20, (3, 1024), generator=gen, device=dev, dtype=torch.int32)
    dist = torch.rand((3, 1024), generator=gen, device=dev) + 0.5
    rayp = torch.cat([torch.eye(3, device=dev).reshape(-1),
                      torch.tensor([0.0, 0.0, 0.0, 0.01, 0.01, 8.0, 8.0], device=dev)])
    poses = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]] * 2, device=dev)
    margs, mg, _ = _mlp_inputs(dev, 2, 300, 18)
    mtable, w0, b0, w1, b1, mlp_coords = margs
    feats = permuto_cuda.encode_mlp_fwd(*margs, *consts)[1]
    pts = torch.randn((3, 500), generator=gen, device=dev)
    cen = torch.randn((6, 3), generator=gen, device=dev)
    valid = torch.ones((6,), dtype=torch.bool, device=dev)
    return {
        "encode_fwd": lambda: permuto_cuda.encode_fwd(table, coords, *consts),
        "encode_bwd_table": lambda: permuto_cuda.encode_bwd_table(coords, g, *consts),
        "batched_gather": lambda: permuto_cuda.batched_gather(values, vidx),
        "encode_fwd_moe": lambda: permuto_cuda.encode_fwd_moe(tables, mcoords, experts, *mconsts),
        "encode_fwd_moe_rays": lambda: permuto_cuda.encode_fwd_moe_rays(
            tables, orig, dist, experts, rayp, poses, 0, *mconsts, log2_ks=10, width=16,
            coord_scale=0.5, coord_shift=0.5),
        "gather_pairs": lambda: permuto_cuda.gather_pairs(rows_t, ridx),
        "table_grad": lambda: permuto_cuda.table_grad(ridx, gv, 256),
        "encode_mlp_fwd": lambda: permuto_cuda.encode_mlp_fwd(*margs, *consts),
        "encode_mlp_bwd": lambda: permuto_cuda.encode_mlp_bwd(mlp_coords, feats, mg, w0, b0, w1, *consts),
        "topk2_fields": lambda: topk.topk2_fields(pts, cen, valid),
    }


def test_each_wrapper_counts_one_launch_per_call(cuda):
    calls = _wrapper_calls(cuda)
    names = [name for name, _, _ in permuto_cuda.KERNELS + topk.KERNELS]
    assert sorted(calls) == sorted(names)
    for name, call in calls.items():
        counts = topk.LAUNCHES if name == "topk2_fields" else permuto_cuda.LAUNCHES
        for _ in range(2):
            before = dict(counts)
            call()
            assert counts == dict(before, **{name: before[name] + 1}), name
    torch.cuda.synchronize()


@pytest.mark.parametrize("lead,t,m", [((2,), 128, 500), ((32, 16), 4096, 36864)])
def test_table_grad_matches_plain(cuda, lead, t, m):
    """Atomics change the summation order: max abs <= 1e-4 * max|plain|;
    an all-zero gradient stays exactly zero."""
    gen = torch.Generator(cuda).manual_seed(10)
    idx = torch.randint(0, t, lead + (m,), generator=gen, device=cuda)
    gv = torch.randn(lead + (2, m), generator=gen, device=cuda)
    got = permuto_cuda.table_grad(idx, gv, t)
    want = permuto_cuda.table_grad_plain(idx, gv, t)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert float(permuto_cuda.table_grad(idx, torch.zeros_like(gv), t).abs().max()) == 0.0


# -- the staged histograms (encode_bwd_table, table_grad) -----------------------


def _over_stale_nan(dev, shape, call):
    """call() right after a freed block of ``shape`` f32 was filled with NaN:
    the wrapper's output, uninitialised where one block writes every entry of
    its row, takes that block, so an entry the kernel leaves unwritten shows."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stale = torch.full(shape, float("nan"), device=dev)
    ptr = stale.data_ptr()
    del stale
    out = call()
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr
    return out


@pytest.mark.parametrize("b,p,points,variant", [
    (32, 12288, "uniform", "staged"),  # the training shape
    (32, 12288, "one coarse cell", "staged"),  # every point within 1e-3: one cell of each coarse level
    (1, 100_000, "uniform", "staged, split rows"),  # 16 (field, level) rows split over blocks
    (3, 1000, "zero cotangents", "staged"),
])
def test_encode_bwd_table_staged_matches_plain(cuda, b, p, points, variant):
    """Staged histograms at the production capacities (512, 1024, 4096 x 14):
    max abs <= 1e-4 * max|plain| (atomics change the summation order), one
    launch, and every entry past a level's capacity exactly 0 in an output
    that was not zeroed first."""
    _, coords, g, consts = _inputs(cuda, b, p, 19)
    if points == "one coarse cell":
        coords = 0.37 + coords * (1e-3 / 1.5)
    if points == "zero cotangents":
        g = torch.zeros_like(g)
    assert permuto_cuda.encode_bwd_table_variant(coords, consts[0], consts[3]) == variant
    before = permuto_cuda.LAUNCHES["encode_bwd_table"]
    got = _over_stale_nan(cuda, (b, 2, 16, 4096), lambda: permuto_cuda.encode_bwd_table(coords, g, *consts))
    assert permuto_cuda.LAUNCHES["encode_bwd_table"] == before + 1
    want = permuto_cuda.encode_bwd_table_plain(coords, g, *consts, 4096)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for level, cap in enumerate(consts[3]):
        assert float(got[:, :, level, cap:].abs().sum()) == 0.0
    if points == "zero cotangents":
        assert float(got.abs().max()) == 0.0


def test_encode_bwd_table_direct_above_the_staged_budget(cuda):
    """log2_hashmap_size 14: levels of 16,384 entries, a (2, T) histogram of
    128 KB, above the staged maximum: the direct variant, zeroed output."""
    enc = PermutohedralEncoding(**dict(PRODUCTION, log2_hashmap_size=14))
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    _, coords, g, _ = _inputs(cuda, 2, 3000, 20)
    assert permuto_cuda.encode_bwd_table_variant(coords, consts[0], consts[3]) == "direct"
    got = permuto_cuda.encode_bwd_table(coords, g, *consts)
    want = permuto_cuda.encode_bwd_table_plain(coords, g, *consts, enc.capacity)
    torch.cuda.synchronize()
    assert got.shape == (2, 2, 16, 16384)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("rows,t,m,offset,pairs,variant", [
    (512, 4096, 36864, 0, "uniform", "staged"),  # the 2D field set's shape
    (512, 4096, 36864, 0, "one index", "staged"),  # every pair of a row on one entry
    (3, 4096, 4099, 0, "uniform", "staged"),  # M % 4 != 0: scalar loads
    (600, 4096, 4096, 1, "uniform", "staged"),  # inputs off 16-byte alignment: scalar loads
    (70_000, 16, 7, 0, "uniform", "staged"),  # more rows than gridDim.y holds (rows on grid x)
    (2, 4096, 100_000, 0, "uniform", "staged, split rows"),  # few rows, many pairs
    (4, 16384, 1001, 0, "uniform", "direct"),  # T above the staged maximum
    (5, 4096, 9000, 0, "zero values", "staged"),
])
def test_table_grad_variants_match_plain(cuda, rows, t, m, offset, pairs, variant):
    """max abs <= 1e-4 * max|plain| (atomics), one launch; an output that
    one block a row writes without a memset has no stale entry; zero values
    give exact zeros."""
    gen = torch.Generator(cuda).manual_seed(21)
    idx = torch.randint(0, t, (offset + rows * m,), generator=gen, device=cuda)[offset:].view(rows, m)
    gv = torch.randn((offset + rows * 2 * m,), generator=gen, device=cuda)[offset:].view(rows, 2, m)
    if pairs == "one index":
        idx = torch.full_like(idx, t // 3)
    if pairs == "zero values":
        gv = torch.zeros_like(gv)
    assert permuto_cuda.table_grad_variant(idx, gv, t) == variant
    before = permuto_cuda.LAUNCHES["table_grad"]
    call = lambda: permuto_cuda.table_grad(idx, gv, t)  # noqa: E731
    got = _over_stale_nan(cuda, (rows, 2, t), call) if variant == "staged" else call()
    assert permuto_cuda.LAUNCHES["table_grad"] == before + 1
    want = permuto_cuda.table_grad_plain(idx, gv, t)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    if pairs == "zero values":
        assert float(got.abs().max()) == 0.0


def test_gather_blend_on_card_matches_cpu(cuda):
    """gather_blend's value and table / weight gradients on the card (both
    kernels) against the CPU (plain versions), 3D lattice at production
    constants."""
    enc = PermutohedralEncoding(**PRODUCTION).to(cuda)
    gen = torch.Generator(cuda).manual_seed(11)
    table = (torch.rand((4, 2, 16, 4096), generator=gen, device=cuda) * 2 - 1).requires_grad_(True)
    coords = torch.rand((4, 3, 999), generator=gen, device=cuda).requires_grad_(True)
    out = enc.gather_fm_soa({"table": table}, coords.unbind(-2))
    g = torch.randn(out.shape, generator=gen, device=cuda)
    before = dict(permuto_cuda.LAUNCHES)
    out.backward(g)
    assert permuto_cuda.LAUNCHES["table_grad"] == before["table_grad"] + 1
    assert permuto_cuda.LAUNCHES["gather_pairs"] == before["gather_pairs"] + 1
    cpu_t = table.detach().cpu().requires_grad_(True)
    cpu_c = coords.detach().cpu().requires_grad_(True)
    want = enc.to("cpu").gather_fm_soa({"table": cpu_t}, cpu_c.unbind(-2))
    want.backward(g.cpu())
    assert float((out.detach().cpu() - want.detach()).abs().max()) <= 1e-5
    assert float((table.grad.cpu() - cpu_t.grad).abs().max()) <= 1e-4 * float(cpu_t.grad.abs().max())
    assert float((coords.grad.cpu() - cpu_c.grad).abs().max()) <= 1e-4 * float(cpu_c.grad.abs().max())


# -- the fused training route (encode_mlp_fwd, encode_mlp_bwd) ------------------

SMALL = dict(
    pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2,
)


def _mlp_inputs(dev, b, p, seed, widths=PRODUCTION, h=32, o=4):
    enc = PermutohedralEncoding(**widths)
    gen = torch.Generator(dev).manual_seed(seed)
    n_levels, t = enc.nr_levels, enc.capacity
    d = 2 * n_levels
    table = torch.rand((b, 2, n_levels, t), generator=gen, device=dev) * 2 - 1
    coords = torch.rand((b, 3, p), generator=gen, device=dev) * 1.5 - 0.25
    w0 = (torch.rand((b, d, h), generator=gen, device=dev) * 2 - 1) / d**0.5
    b0 = (torch.rand((b, h), generator=gen, device=dev) * 2 - 1) / d**0.5
    w1 = (torch.rand((b, h, o), generator=gen, device=dev) * 2 - 1) / h**0.5
    b1 = (torch.rand((b, o), generator=gen, device=dev) * 2 - 1) / h**0.5
    g = torch.randn((b, o, p), generator=gen, device=dev)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    return (table, w0, b0, w1, b1, coords), g, consts


@pytest.mark.parametrize("b,p,small", [(1, 1, False), (3, 1000, True), (32, 12288, False)])
def test_encode_mlp_fwd_and_bwd_match_plain(cuda, b, p, small):
    """Forward max abs <= 1e-5 (outputs and residual); backward: table
    gradient <= 1e-4 * max|plain| (atomics), weight gradients <= 1e-4
    relative to their largest entry."""
    kw = dict(widths=SMALL, h=8) if small else {}
    args, g, consts = _mlp_inputs(cuda, b, p, 12, **kw)
    before = dict(permuto_cuda.LAUNCHES)
    out, feats = permuto_cuda.encode_mlp_fwd(*args, *consts)
    want_out, want_feats = permuto_cuda.encode_mlp_fwd_plain(*args, *consts)
    torch.cuda.synchronize()
    assert float((out - want_out).abs().max()) <= 1e-5
    assert float((feats - want_feats).abs().max()) <= 1e-5
    table, w0, b0, w1, b1, coords = args
    got = permuto_cuda.encode_mlp_bwd(coords, feats, g, w0, b0, w1, *consts)
    want = permuto_cuda.encode_mlp_bwd_plain(coords, feats, g, w0, b0, w1, *consts)
    torch.cuda.synchronize()
    for name, a, w in zip(("table", "w0", "b0", "w1", "b1"), got, want):
        assert a.shape == w.shape, name
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    assert permuto_cuda.LAUNCHES["encode_mlp_fwd"] == before["encode_mlp_fwd"] + 1
    assert permuto_cuda.LAUNCHES["encode_mlp_bwd"] == before["encode_mlp_bwd"] + 1


def test_encode_mlp_fused_autograd_on_card(cuda):
    """The autograd function on the card: value and every gradient against
    the unfused route (encode_fused + the bmm MLP) on the same inputs; the
    coordinates get a zero gradient."""
    args, g, consts = _mlp_inputs(cuda, 4, 777, 13)
    fused = [a.clone().requires_grad_(True) for a in args]
    unfused = [a.clone().requires_grad_(True) for a in args]
    out = permuto.encode_mlp_fused(*fused, *consts)
    out.backward(g)
    table, w0, b0, w1, b1, coords = unfused
    feats = permuto.encode_fused(table, coords, *consts)
    want = torch.matmul(w1.transpose(-1, -2), torch.relu(torch.matmul(w0.transpose(-1, -2), feats) + b0[..., None])) + b1[..., None]
    want.backward(g)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-5
    for a, w in zip(fused[:5], unfused[:5]):
        assert float((a.grad - w.grad).abs().max()) <= 1e-4 * float(w.grad.abs().max())
    assert torch.count_nonzero(fused[5].grad) == 0


def test_new_wrappers_never_take_the_plain_path(cuda):
    """Mixed devices raise; shapes the kernels do not take raise on the card
    instead of falling back."""
    args, g, consts = _mlp_inputs(cuda, 1, 10, 14)
    table, w0, b0, w1, b1, coords = args
    with pytest.raises(ValueError):
        permuto_cuda.encode_mlp_fwd(table, w0.cpu(), b0, w1, b1, coords, *consts)
    out, feats = permuto_cuda.encode_mlp_fwd(*args, *consts)
    with pytest.raises(ValueError):
        permuto_cuda.encode_mlp_bwd(coords, feats, g.cpu(), w0, b0, w1, *consts)
    wide = _mlp_inputs(cuda, 1, 10, 15, h=64)[0]
    with pytest.raises(ValueError, match="at most"):
        permuto_cuda.encode_mlp_fwd(*wide, *consts)
    idx = torch.zeros((2, 5), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        permuto_cuda.gather_pairs(torch.zeros((2, 2, 8), device=cuda), idx.cpu())
    with pytest.raises(ValueError, match="2 features"):
        permuto_cuda.gather_pairs(torch.zeros((2, 3, 8), device=cuda), idx)
    with pytest.raises(ValueError, match="2 features"):
        permuto_cuda.table_grad(idx, torch.zeros((2, 3, 5), device=cuda), 8)
    with pytest.raises(ValueError):
        permuto_cuda.table_grad(idx, torch.zeros((2, 2, 5)), 8)


# -- the lattice, the encode's designs, the staged fused backward -------------------


def test_lattice_matches_plain_bit_for_bit(cuda):
    """The kernels' lattice_level (ngm_lattice_debug) against the plain
    lattice_keys_and_weights_soa on the card, at the production constants:
    indices exact, weights within 1e-6, for uniform points and for points
    built to sit on every level's rounding boundaries, where a swapped
    corner has near-zero weight and no encode output would show it."""
    import chip_smoke

    enc = PermutohedralEncoding(**PRODUCTION)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    uniform = np.random.default_rng(30).uniform(-0.5, 1.5, (3, 20_000)).astype(np.float32)
    boundary = chip_smoke.lattice_boundary_points(*consts[:3])
    for pts in (uniform, boundary):
        coords = torch.from_numpy(pts).to(cuda)
        idx, w = permuto_cuda.lattice_debug(coords, *consts)
        s, sh, el = (torch.tensor(v, dtype=torch.float32, device=cuda) for v in consts[:3])
        want_idx, want_w = permuto.lattice_keys_and_weights_soa(coords.unbind(0), s, sh, el, consts[3])
        assert torch.equal(idx, want_idx)
        assert float((w - want_w).abs().max()) <= 1e-6
    assert int((w.abs() < 1e-6).sum()) > 1000  # the boundary points do sit on boundaries


@pytest.mark.parametrize("b,p", [(3, 1000), (32, 12288), (1, 100_000)])
def test_encode_fwd_staged_matches_plain(cuda, b, p):
    """The staged encode_fwd within 1e-5 of the plain version, one launch a
    call, at a short shape, the training shape and one field whose points
    are split over blocks."""
    table, coords, _, consts = _inputs(cuda, b, p, 22)
    assert permuto_cuda.encode_fwd_variant(table) == "staged"
    before = permuto_cuda.LAUNCHES["encode_fwd"]
    got = permuto_cuda.encode_fwd(table, coords, *consts)
    assert permuto_cuda.LAUNCHES["encode_fwd"] == before + 1
    want = permuto_cuda.encode_fwd_plain(table, coords, *consts)
    assert float((got - want).abs().max()) <= 1e-5


def test_encode_fwd_direct_above_the_staged_budget(cuda):
    """log2_hashmap_size 14: level rows of 16,384 entries, 128 KB, above the
    staged maximum: the direct design by shape."""
    enc = PermutohedralEncoding(**dict(PRODUCTION, log2_hashmap_size=14))
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    gen = torch.Generator(cuda).manual_seed(23)
    table = torch.rand((2, 2, 16, 16384), generator=gen, device=cuda) * 2 - 1
    coords = torch.rand((2, 3, 3000), generator=gen, device=cuda) * 1.5 - 0.25
    assert permuto_cuda.encode_fwd_variant(table) == "direct"
    got = permuto_cuda.encode_fwd(table, coords, *consts)
    assert float((got - permuto_cuda.encode_fwd_plain(table, coords, *consts)).abs().max()) <= 1e-5


@pytest.mark.parametrize("log2_t,variant", [(12, "staged"), (14, "direct")])
@pytest.mark.parametrize("levels", ["all", "coarse only", "fine only"])
def test_encode_mlp_bwd_designs_match_plain(cuda, log2_t, variant, levels):
    """encode_mlp_bwd's staged design (log2_hashmap_size 12) and its direct
    design (14: level rows above the staged maximum), both taken by shape,
    at the training shape, with dL/df on all levels, on the two coarsest
    only (many points a cell) or the two finest only (w0's rows of the
    other levels zeroed): table gradient max abs <= 1e-4 x max|plain|
    (atomics), weight gradients <= 1e-4 relative, one launch a call. Points
    with a pre-activation within rounding of the ReLU kink carry no
    cotangent (chip_smoke.off_the_relu_kink): there the kernels and the
    plain matrix product may round to different masks, and at these inputs
    one such point moved a table gradient entry of the direct design, all
    levels, by 2.6e-3 against a 6.7e-4 limit."""
    import chip_smoke

    widths = dict(PRODUCTION, log2_hashmap_size=log2_t)
    (table, w0, b0, w1, b1, coords), g, consts = _mlp_inputs(cuda, 32, 12288, 24, widths=widths)
    level = torch.arange(32, device=cuda)[:, None] // 2
    if levels != "all":
        w0 = w0 * ((level < 2) if levels == "coarse only" else (level >= 14))
    feats = permuto_cuda.encode_mlp_fwd(table, w0, b0, w1, b1, coords, *consts)[1]
    args = chip_smoke.off_the_relu_kink(torch, (coords, feats, g, w0, b0, w1, *consts))[0]
    assert permuto_cuda.encode_mlp_bwd_variant(coords, consts[0], consts[3]) == variant
    before = permuto_cuda.LAUNCHES["encode_mlp_bwd"]
    got = permuto_cuda.encode_mlp_bwd(*args)
    assert permuto_cuda.LAUNCHES["encode_mlp_bwd"] == before + 1
    want = permuto_cuda.encode_mlp_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, a, w in zip(("table", "w0", "b0", "w1", "b1"), got, want):
        assert a.shape == w.shape, name
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    if levels != "all":
        keep = slice(0, 2) if levels == "coarse only" else slice(14, 16)
        rest = torch.ones(16, dtype=torch.bool, device=cuda)
        rest[keep] = False
        assert float(got[0][:, :, rest].abs().max()) == 0.0


@pytest.mark.parametrize("b,p,log2_t,variant", [
    (32, 12288, 12, "staged"),  # the training shape: one block a (field, level)
    (1, 100_000, 12, "staged, split rows"),  # 16 rows split over blocks: a zeroed output
    (2, 3000, 14, "direct"),  # (2, T) rows of 128 KB, above the staged maximum
])
def test_encode_mlp_bwd_by_shape_over_a_stale_block(cuda, b, p, log2_t, variant):
    """The design taken by shape, right after a freed block of the table
    gradient's size was filled with NaN: an output that the staged design
    writes without a memset takes that block, so an entry left unwritten
    shows; every entry past a level's capacity is exactly 0."""
    widths = dict(PRODUCTION, log2_hashmap_size=log2_t)
    (table, w0, b0, w1, b1, coords), g, consts = _mlp_inputs(cuda, b, p, 25, widths=widths)
    feats = permuto_cuda.encode_mlp_fwd(table, w0, b0, w1, b1, coords, *consts)[1]
    args = (coords, feats, g, w0, b0, w1, *consts)
    assert permuto_cuda.encode_mlp_bwd_variant(coords, consts[0], consts[3]) == variant
    t = 1 << log2_t
    got = _over_stale_nan(cuda, (b, 2, 16, t), lambda: permuto_cuda.encode_mlp_bwd(*args)[0])
    want = permuto_cuda.encode_mlp_bwd_plain(*args)[0]
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for level, cap in enumerate(consts[3]):
        assert float(got[:, :, level, cap:].abs().sum()) == 0.0


# -- encode_mlp_fwd's designs, the ray encode's tile runs, the lattice's fallback --


@pytest.mark.parametrize("log2_t,variant", [(12, "staged"), (14, "direct")])
@pytest.mark.parametrize("b,p,h,o", [
    (32, 12288, 32, 4),  # the training shape at the production widths
    (3, 1000, 32, 4),  # P not a multiple of a block's points
    (2, 777, 20, 3),  # H < 32 and O < 4: the zero-padded weights
])
def test_encode_mlp_fwd_by_shape_over_a_stale_block(cuda, log2_t, variant, b, p, h, o):
    """encode_mlp_fwd's design taken by shape (staged at T = 4,096, direct
    at T = 16,384), right after a freed block of the output's size was
    filled with NaN: outputs within 1e-5 of the plain version, every entry
    written, the residual equal to encode_fwd's output bit for bit, one
    launch a call."""
    widths = dict(PRODUCTION, log2_hashmap_size=log2_t)
    (table, w0, b0, w1, b1, coords), _, consts = _mlp_inputs(cuda, b, p, 26, widths=widths, h=h, o=o)
    assert permuto_cuda.encode_mlp_fwd_variant(table) == variant
    before = permuto_cuda.LAUNCHES["encode_mlp_fwd"]
    got = {}
    out = _over_stale_nan(cuda, (b, o, p), lambda: got.setdefault(
        "fwd", permuto_cuda.encode_mlp_fwd(table, w0, b0, w1, b1, coords, *consts))[0])
    assert permuto_cuda.LAUNCHES["encode_mlp_fwd"] == before + 1
    feats = got["fwd"][1]
    want_out, want_feats = permuto_cuda.encode_mlp_fwd_plain(table, w0, b0, w1, b1, coords, *consts)
    assert bool(torch.isfinite(out).all())
    assert float((out - want_out).abs().max()) <= 1e-5
    assert float((feats - want_feats).abs().max()) <= 1e-5
    assert torch.equal(feats, permuto_cuda.encode_fwd(table, coords, *consts))


def _ray_inputs(dev, experts, seed, log2_t=12):
    """The ray encode's arguments for tiles owned by ``experts`` (int32,
    sorted), tables U(-1, 1) at the production encoding (with
    ``log2_hashmap_size`` log2_t)."""
    n = int(experts.max()) + 1
    gen, tables, _, consts = _moe_inputs(dev, 1, n, seed)
    if log2_t != 12:
        enc = PermutohedralEncoding(**dict(PRODUCTION, log2_hashmap_size=log2_t))
        consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
        tables = torch.rand((n, 2, 16, enc.capacity), generator=gen, device=dev) * 2 - 1
    tiles = experts.shape[0]
    orig = torch.randint(0, 8192 * 1024, (tiles, 1024), generator=gen, device=dev, dtype=torch.int32)
    dist = torch.rand((tiles, 1024), generator=gen, device=dev) * 4 + 0.5
    q = torch.randn((n, 4), generator=gen, device=dev)
    poses = torch.cat([torch.randn((n, 3), generator=gen, device=dev) * 0.3,
                       q / q.norm(dim=-1, keepdim=True)], 1).contiguous()
    rot = torch.linalg.qr(torch.randn((3, 3), generator=gen, device=dev))[0]
    rayp = torch.cat([rot.reshape(-1), torch.tensor([0.3, -0.2, 3.0, 1 / 560.0, 1 / 560.0, 320.0, 240.0],
                                                     device=dev)]).contiguous()
    args = (tables, orig, dist, experts, rayp, poses, 4096, *consts)
    return args, dict(log2_ks=10, width=640, coord_scale=0.5, coord_shift=0.5)


@pytest.mark.parametrize("t,mlp_fwd", [
    (256, "staged"),
    (4096, "staged"),  # the production tables
    (8192, "staged"),
    (12288, "staged"),  # encode_fwd's largest staged rows: (2, T) f32 in 96 KB
    (12289, "direct"),
    (16384, "direct"),
])
def test_encode_mlp_fwd_variant_by_shape(cuda, t, mlp_fwd):
    """The design encode_mlp_fwd takes for tables of T entries a level row,
    on each side of the staged maximum."""
    table = torch.zeros((1, 2, 16, t), device=cuda)
    assert permuto_cuda.encode_mlp_fwd_variant(table) == mlp_fwd


# tiles' owners: field changes inside a run of consecutive tiles, a field
# that owns a single tile, and a long run
RAY_EXPERTS = [0, 0, 0, 1, 2, 2, 2, 2, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 5, 6, 6]


@pytest.mark.parametrize("log2_t", [12, 14])
@pytest.mark.parametrize("live", [0, 11, len(RAY_EXPERTS)])
def test_encode_fwd_moe_rays_tile_runs_and_live_count(cuda, live, log2_t):
    """The ray encode at T = 4,096 and T = 16,384 over tiles whose field
    changes inside a run of consecutive tiles, a field of one tile, and
    num_live at 0, in the middle and at all tiles: live tiles within 1e-5
    of the plain version, dead tiles never written (they keep the NaN of a
    freed block), one launch a call, no host sync."""
    experts = torch.tensor(RAY_EXPERTS, dtype=torch.int32, device=cuda)
    args, kw = _ray_inputs(cuda, experts, 27, log2_t)
    num_live = torch.tensor(live, dtype=torch.int32, device=cuda)
    before = permuto_cuda.LAUNCHES["encode_fwd_moe_rays"]
    shape = (len(RAY_EXPERTS), 32, 1024)

    def call():
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the wrapper raises
        try:
            return permuto_cuda.encode_fwd_moe_rays(*args, **kw, num_live_tiles=num_live)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    got = _over_stale_nan(cuda, shape, call)
    assert permuto_cuda.LAUNCHES["encode_fwd_moe_rays"] == before + 1
    want = permuto_cuda.encode_fwd_moe_rays_plain(*args, **kw)
    assert bool(torch.isnan(got[live:]).all())
    if live:
        assert float((got[:live] - want[:live]).abs().max()) <= 1e-5


def test_lattice_far_out_takes_the_select_form(cuda):
    """Points so far out that the elevated sums lose whole units (the
    remainder sum leaves the fast form's range) and non-finite points: the
    kernels' lattice still equals the plain version's, indices exactly and
    weights within 1e-6 where they are finite."""
    enc = PermutohedralEncoding(**PRODUCTION)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    rng = np.random.default_rng(32)
    pts = np.concatenate([
        rng.uniform(-1.0, 1.0, (3, 4000)) * 10.0 ** rng.integers(0, 5, (1, 4000)),
        np.array([[np.nan, 0.5, 0.5], [0.5, np.inf, 0.5], [0.5, 0.5, -np.inf]]).T,
    ], axis=1).astype(np.float32)
    coords = torch.from_numpy(pts).to(cuda)
    idx, w = permuto_cuda.lattice_debug(coords, *consts)
    s, sh, el = (torch.tensor(v, dtype=torch.float32, device=cuda) for v in consts[:3])
    want_idx, want_w = permuto.lattice_keys_and_weights_soa(coords.unbind(0), s, sh, el, consts[3])
    finite = torch.isfinite(coords).all(0)
    assert torch.equal(idx[..., finite], want_idx[..., finite])
    assert float((w[..., finite] - want_w[..., finite]).abs().max()) <= 1e-6


def _topk_case(dev, case):
    """(points (3, P), centres (N, 3), valid (N,)) of one topk2_fields case."""
    gen = torch.Generator(dev).manual_seed(81)
    pts = torch.randn((3, 5000), generator=gen, device=dev) * 0.05 + 1.0
    if case == "ties":  # duplicates and pairs equidistant from points that sit on their middle
        mid = pts[:, :4].T
        v = torch.randn((4, 3), generator=gen, device=dev)
        cen = torch.cat([mid + v, mid - v, mid + v, torch.randn((6, 3), generator=gen, device=dev)])
        valid = torch.ones(cen.shape[0], dtype=torch.bool, device=dev)
    elif case in ("one centre", "one invalid centre"):
        cen = torch.randn((1, 3), generator=gen, device=dev)
        valid = torch.tensor([case == "one centre"], device=dev)
    elif case in ("all invalid", "one valid"):
        cen = torch.randn((9, 3), generator=gen, device=dev)
        valid = torch.zeros(9, dtype=torch.bool, device=dev)
        valid[5] = case == "one valid"
    else:  # 1,024 centres in clusters, some near the points, a quarter invalid
        hubs = torch.randn((16, 3), generator=gen, device=dev) * 3 + 1.0
        cen = hubs.repeat_interleave(64, 0) + torch.randn((1024, 3), generator=gen, device=dev) * 0.2
        valid = torch.rand(1024, generator=gen, device=dev) > 0.25
        pts = torch.cat([pts, hubs.T.repeat_interleave(300, 1) + torch.randn((3, 4800), generator=gen,
                                                                            device=dev) * 0.3], 1)
    return pts.contiguous(), cen.contiguous(), valid


@pytest.mark.parametrize("case", ["ties", "one centre", "one invalid centre", "all invalid", "one valid",
                                  "1024 clustered"])
def test_topk2_fields_exact_on_edge_cases(cuda, case):
    """The branch-free, pruned kernel against the plain version, bit for bit
    (distances and indices): ties go to the lower index (duplicate and
    equidistant centres), N = 1 pads with (+inf, 0), fewer than two valid
    centres give the first invalid indices, and 1,024 clustered centres
    are pruned box by box without losing a winner. Each box kept as many
    centres as the plain model of the pruning keeps (the kernel's own
    counts, from a launch that LAUNCHES does not count)."""
    pts, cen, valid = _topk_case(cuda, case)
    before = topk.LAUNCHES["topk2_fields"]
    d, i = topk.topk2_fields(pts, cen, valid)
    assert topk.LAUNCHES["topk2_fields"] == before + 1
    wd, wi = topk.topk2_fields_plain(pts, cen, valid)
    torch.cuda.synchronize()
    assert torch.equal(d, wd) and torch.equal(i, wi)
    counts = topk.topk2_box_survivors(pts, cen, valid)
    assert topk.LAUNCHES["topk2_fields"] == before + 1
    keep = topk.topk2_survivors_plain(pts, cen, valid)
    assert torch.equal(counts, keep.sum(1, dtype=torch.int32))
    if case == "1024 clustered":  # the pruning drops most centres here
        assert float(counts.float().mean()) < 0.5 * cen.shape[0]


# tiles' owners of the carried encode's tests: fields of one tile at every
# position of a group of 4 consecutive tiles, runs across such groups, and
# a field change at every tile
MOE_EXPERTS = [0, 1, 1, 1, 1, 2, 3, 3, 3, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 7, 8, 9, 10, 10, 10, 10]


@pytest.mark.parametrize("log2_t", [12, 14])
@pytest.mark.parametrize("live", [0, 13, len(MOE_EXPERTS)])
def test_encode_fwd_moe_tile_runs_and_live_count(cuda, live, log2_t):
    """The carried encode at T = 4,096 and T = 16,384 over field runs of
    one tile and runs across groups of 4 tiles, num_live at 0, in the middle
    and at all tiles: live tiles within 1e-5 of the plain version, dead
    tiles never written (they keep the NaN of a freed block), one launch a
    call, no host sync."""
    experts = torch.tensor(MOE_EXPERTS, dtype=torch.int32, device=cuda)
    args = _ray_inputs(cuda, experts, 28, log2_t)[0]
    tables, consts = args[0], args[7:]
    gen = torch.Generator(cuda).manual_seed(28)
    coords = torch.rand((len(MOE_EXPERTS), 3, 1024), generator=gen, device=cuda) * 1.5 - 0.25
    num_live = torch.tensor(live, dtype=torch.int32, device=cuda)
    before = permuto_cuda.LAUNCHES["encode_fwd_moe"]

    def call():
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the wrapper raises
        try:
            return permuto_cuda.encode_fwd_moe(tables, coords, experts, *consts, num_live_tiles=num_live)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    got = _over_stale_nan(cuda, (len(MOE_EXPERTS), 32, 1024), call)
    assert permuto_cuda.LAUNCHES["encode_fwd_moe"] == before + 1
    want = permuto_cuda.encode_fwd_moe_plain(tables, coords, experts, *consts)
    assert bool(torch.isnan(got[live:]).all())
    if live:
        assert float((got[:live] - want[:live]).abs().max()) <= 1e-5


@pytest.mark.parametrize("log2_t", [12, 14])
def test_encode_fwd_moe_rays_bit_for_bit(cuda, log2_t):
    """The ray encode's output at T = 4,096 and T = 16,384 on a fixed seed
    equals the plain version's bit for bit, as the kernel's did before the
    two MoE encodes shared one body (the lattice and the ray rebuild round
    as the plain version does, and each feature sums its corners in the
    same order)."""
    args, kw = _ray_inputs(cuda, torch.tensor(RAY_EXPERTS, dtype=torch.int32, device=cuda), 30, log2_t)
    got = permuto_cuda.encode_fwd_moe_rays(*args, **kw)
    assert torch.equal(got, permuto_cuda.encode_fwd_moe_rays_plain(*args, **kw))


def test_prefetched_frames_equal_synchronous_frames(cuda, monkeypatch):
    """Frames copied ahead from pinned memory on the prefetcher's side
    stream equal the synchronous upload byte for byte, over 12 frames of
    the production scene. The side stream is the slow one: each copy is
    queued behind ~50 ms of device sleep while the consumer's stream is
    idle, so a frame read without waiting on its event would be read
    before its copy ran."""
    import chip_smoke

    from neural_graph_mapping_tpu_torch.config import str_to_object
    from neural_graph_mapping_tpu_torch.utils.prefetch import FramePrefetcher

    upload = FramePrefetcher._upload

    def slow_upload(self, rgbd):
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's ~2 GHz clock
        return upload(self, rgbd)

    monkeypatch.setattr(FramePrefetcher, "_upload", slow_upload)
    ds = str_to_object(chip_smoke.CONFIG["dataset_type"])(chip_smoke.CONFIG["dataset_config"])
    ds.load_slam_results()
    want = [torch.from_numpy(ds[fid]["rgbd"]).to(cuda) for fid in range(12)]
    torch.cuda.synchronize()
    pf = FramePrefetcher(ds, range(12), depth=2, to_device=True, device=cuda)
    assert pf._stream is not None and pf._stream != torch.cuda.current_stream(cuda)
    try:
        for fid in range(12):
            got = pf.get(fid)["rgbd_dev"]
            assert got.is_cuda and got.dtype == torch.float32
            copied = got.clone()  # on the current stream, right after get's wait
            assert torch.equal(copied, want[fid]), fid
    finally:
        pf.close()


def test_extract_mesh_on_card_matches_cpu_route(cuda, monkeypatch):
    """A map trained on the card for 4 frames, meshed on the card and on the
    CPU (plain versions) from the same state: every block's volume within
    1e-4, and meshing launches the top-2 and carried MoE encode kernels."""
    import copy

    import chip_smoke

    from neural_graph_mapping_tpu_torch.config import str_to_object
    from neural_graph_mapping_tpu_torch.mapping import engine, meshing

    cfg = dict(chip_smoke.CONFIG, dataset_config={"num_frames": 4, "width": 40, "height": 30,
                                                  "fx": 35.0, "fy": 35.0})
    ds = str_to_object(cfg["dataset_type"])(cfg["dataset_config"])
    ds.load_slam_results()
    ngm = engine.NeuralGraphMap(cfg, device="cuda")
    for fid in range(4):
        ngm.process_frame(ds, fid, ds[fid]["rgbd"])
    volumes = []
    orig = meshing.native.marching_tetrahedra

    def record(vol, iso):
        volumes.append(np.array(vol))
        return orig(vol, iso)

    monkeypatch.setattr(meshing.native, "marching_tetrahedra", record)
    m = ngm._map_arrays
    valid = torch.arange(ngm.capacity, device=cuda) < ngm.num_fields
    kw = dict(field_radius=ngm._field_radius, geometry_mode="nrgbd", geometry_factor=20.0,
              resolution=0.3, block_size=16, eval_chunk=16384)
    before = {"topk2_fields": topk.LAUNCHES["topk2_fields"], "moe": permuto_cuda.LAUNCHES["encode_fwd_moe"]}
    got = meshing.extract_mesh(ngm._fset, ngm._params, m.positions, m.orientations, valid, **kw)
    torch.cuda.synchronize()
    assert topk.LAUNCHES["topk2_fields"] > before["topk2_fields"]
    assert permuto_cuda.LAUNCHES["encode_fwd_moe"] > before["moe"]
    gpu_volumes, volumes[:] = list(volumes), []
    cpu = {k: v.cpu() for k, v in ngm._params.items()}
    want = meshing.extract_mesh(copy.deepcopy(ngm._fset).to("cpu"), cpu, m.positions.cpu(),
                                m.orientations.cpu(), valid.cpu(), **kw)
    assert got is not None and want is not None
    assert len(gpu_volumes) == len(volumes) > 1
    for g, w in zip(gpu_volumes, volumes):
        assert float(np.abs(g - w).max()) <= 1e-4
