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
