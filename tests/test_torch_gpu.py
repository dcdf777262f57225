"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (the kernels
have no CPU mode). Run them on a GPU machine with
``python -m pytest tests/test_torch_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from neural_graph_mapping_tpu_torch.ops import permuto, permuto_cuda
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
