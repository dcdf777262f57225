"""The transmittance's cumulative product (ops/quadrature.cumprod): its
backward, which reads nothing from the device on the host, against
``torch.cumprod``'s own autograd."""

import pytest
import torch

from neural_graph_mapping_tpu_torch.ops import quadrature


def _factors(case: str, dtype) -> torch.Tensor:
    """(rays, samples) factors 1 - occ in [0, 1], the case's exact zeros set."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((64, 23), generator=gen, dtype=dtype)
    if case == "one zero":
        x[5, 7] = 0.0
    elif case == "several zeros":
        x[torch.rand(x.shape, generator=gen) < 0.2] = 0.0
        x[9, [2, 3, 11]] = 0.0
    elif case == "zero in the last sample":
        x[:, -1] = 0.0
    return x


@pytest.mark.parametrize("case", ["no zero", "one zero", "several zeros", "zero in the last sample"])
def test_cumprod_backward_equals_torch_and_passes_gradcheck(case):
    """float32: the same gradient as ``CumprodBackward0`` bit for bit, zeros
    or none (the same operations on the same values); float64: gradcheck."""
    x = _factors(case, torch.float32)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    ours, ref = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = quadrature.cumprod(ours)
    assert out.grad_fn is not None and "Cumprod" in type(out.grad_fn).__name__
    assert torch.equal(out, torch.cumprod(x, dim=-1))
    (got,) = torch.autograd.grad(out, ours, g)
    (want,) = torch.autograd.grad(torch.cumprod(ref, dim=-1), ref, g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x64 = _factors(case, torch.float64)[:10].clone().requires_grad_(True)
    assert torch.autograd.gradcheck(quadrature.cumprod, (x64,))
