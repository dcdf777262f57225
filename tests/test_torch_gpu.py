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


def test_batched_gather_exact(cuda):
    gen = torch.Generator(cuda).manual_seed(2)
    values = torch.rand((1000, 19200), generator=gen, device=cuda)
    idx = torch.randint(0, 19200, (1000, 640), generator=gen, device=cuda)
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
