"""The fused encode + MLP training route against the JAX package.

The port's ``encode_mlp_fwd`` / ``encode_mlp_bwd`` (their plain versions on
the CPU, which the CUDA kernels are held against on the card) against the
Pallas kernels ``permuto_pallas.encode_mlp_fwd`` / ``encode_mlp_bwd`` run in
interpret mode with f32 MXU operands, and the ``encode_mlp_fused`` autograd
function against the unfused route (``encode_fused`` + ``mlp_fm``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np

from neural_graph_mapping_tpu.ops import permuto_pallas
from neural_graph_mapping_tpu_torch.models.fields import NeuralField
from neural_graph_mapping_tpu_torch.ops import permuto, permuto_cuda
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

SMALL = dict(
    pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2,
)


@pytest.fixture(scope="module")
def enc():
    return PermutohedralEncoding(**SMALL)


def _consts(e):
    return (e._scales_t, e._shifts_t, e._elev_t, e.level_capacities)


def _inputs(lead, p, seed, h=8, o=4):
    """Tables U(-1, 1), coordinates around the unit cube, weights at the
    scale the JAX package's own test uses."""
    rng = np.random.default_rng(seed)
    d = 8
    f32 = np.float32
    return dict(
        table=rng.uniform(-1, 1, lead + (2, 4, 256)).astype(f32),
        w0=(rng.normal(size=lead + (d, h)) * 0.3).astype(f32),
        b0=(rng.normal(size=lead + (h,)) * 0.1).astype(f32),
        w1=(rng.normal(size=lead + (h, o)) * 0.3).astype(f32),
        b1=(rng.normal(size=lead + (o,)) * 0.1).astype(f32),
        coords=rng.uniform(-1.5, 1.5, lead + (3, p)).astype(f32),
        g=rng.normal(size=lead + (o, p)).astype(f32),
    )


_ORDER = ("table", "w0", "b0", "w1", "b1", "coords")


def _jax_residual(feats, p):
    """JAX's native (b, M/128, D, 128) residual -> canonical (b, D, P)."""
    feats = np.asarray(feats)
    b, rows, d, lanes = feats.shape
    return feats.transpose(0, 2, 1, 3).reshape(b, d, rows * lanes)[:, :, :p]


@pytest.mark.parametrize("lead,p", [((), 700), ((), 1024), ((2,), 700)], ids=["p700", "p1024", "two_fields"])
def test_encode_mlp_fwd_matches_pallas(enc, lead, p):
    """Outputs and the feature residual. The JAX package's own comparison
    of this kernel holds features to rtol 1e-3 / atol 1e-2 and outputs to
    atol 1e-3 / rtol 1e-2; the port holds tighter: features atol 1e-4 (the
    Pallas lattice multiplies by 1/scale where the port divides, as for
    encode_fwd in tests/test_torch_permuto.py), outputs atol 1e-4 rtol 1e-4."""
    x = _inputs(lead, p, 0)
    want_out, want_feats = permuto_pallas.encode_mlp_fwd(
        *(jnp.asarray(x[k]) for k in _ORDER), *_consts(enc), interpret=True,
        mxu_dtype=jnp.float32,
    )
    got_out, got_feats = permuto_cuda.encode_mlp_fwd(*(torch.from_numpy(x[k]) for k in _ORDER), *_consts(enc))
    assert got_out.shape == lead + (4, p) and got_feats.shape == lead + (8, p)
    want_feats = _jax_residual(want_feats, p).reshape(lead + (8, p))
    assert_close(want_feats, got_feats, atol=1e-4)
    assert_close(want_out, got_out, atol=1e-4, rtol=1e-4)


def test_encode_mlp_bwd_matches_pallas(enc):
    """All five gradients at P = 900 from the same residual. The JAX
    package's own comparison uses atol 1e-3 / rtol 1e-3; the port holds
    atol 1e-3 / rtol 1e-4 on the table gradient (a histogram of up to ~100
    terms an entry) and atol 1e-4 / rtol 1e-4 on the weights."""
    p = 900
    x = _inputs((), p, 1)
    want_out, want_feats = permuto_pallas.encode_mlp_fwd(
        *(jnp.asarray(x[k]) for k in _ORDER), *_consts(enc), interpret=True,
        mxu_dtype=jnp.float32,
    )
    want = permuto_pallas.encode_mlp_bwd(
        jnp.asarray(x["coords"]), want_feats, jnp.asarray(x["g"]),
        *(jnp.asarray(x[k]) for k in ("w0", "b0", "w1", "b1")), *_consts(enc),
        interpret=True, mxu_dtype=jnp.float32,
    )
    feats = torch.from_numpy(np.ascontiguousarray(_jax_residual(want_feats, p)[0]))
    got = permuto_cuda.encode_mlp_bwd(
        torch.from_numpy(x["coords"]), feats, torch.from_numpy(x["g"]),
        *(torch.from_numpy(x[k]) for k in ("w0", "b0", "w1")), *_consts(enc),
    )
    assert got[0].shape == (2, 4, 256)
    assert_close(want[0], got[0], atol=1e-3, rtol=1e-4, err_msg="grad_table")
    for name, w, g in zip(("dw0", "db0", "dw1", "db1"), want[1:], got[1:]):
        assert g.shape == w.shape, name
        assert_close(w, g, atol=1e-4, rtol=1e-4, err_msg=name)
    assert float(got[0].abs().max()) > 1.0  # the histogram is not trivially zero


def test_encode_mlp_bwd_zero_cotangent(enc):
    x = _inputs((2,), 300, 2)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    _, feats = permuto_cuda.encode_mlp_fwd(*(t[k] for k in _ORDER), *_consts(enc))
    grads = permuto_cuda.encode_mlp_bwd(t["coords"], feats, torch.zeros_like(t["g"]), t["w0"], t["b0"], t["w1"], *_consts(enc))
    assert all(float(g.abs().max()) == 0.0 for g in grads)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one_field", "field_batch"])
def test_encode_mlp_fused_matches_unfused_route(enc, lead):
    """The autograd function's value and every gradient equal the unfused
    route (encode_fused, then NeuralField.mlp_fm) within 1e-5; the
    coordinates get a zero gradient, as in JAX."""
    field = NeuralField(PermutohedralEncoding, SMALL, num_layers=1, dim_out=4)
    x = _inputs(lead, 500, 3, h=8)
    fused = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in _ORDER}
    unfused = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in _ORDER}
    out = permuto.encode_mlp_fused(*(fused[k] for k in _ORDER), *_consts(enc))
    feats = permuto.encode_fused(unfused["table"], unfused["coords"], *_consts(enc))
    want = field.mlp_fm({k: unfused[k] for k in ("w0", "b0", "w1", "b1")}, feats)
    g = torch.from_numpy(x["g"])
    torch.sum(torch.sin(out) * g).backward()
    torch.sum(torch.sin(want) * g).backward()
    assert_close(to_np(want), out, atol=1e-5)
    for k in _ORDER[:5]:
        assert_close(unfused[k].grad, fused[k].grad, atol=1e-5, err_msg=k)
    assert torch.count_nonzero(fused["coords"].grad) == 0


def test_fused_field_apply_matches_unfused(enc):
    """NeuralField.apply_fm_soa with and without fused_mlp on the same
    parameters, field batch of 4: values and parameter gradients 1e-5."""
    kw = dict(encoding_type=PermutohedralEncoding, encoding_kwargs=SMALL, num_layers=1, dim_out=4)
    fused, plain = NeuralField(**kw, fused_mlp=True), NeuralField(**kw)
    params = plain.init(4, torch.Generator().manual_seed(0))
    params["enc.table"] = params["enc.table"] * 100.0
    coords = tuple(torch.from_numpy(c) for c in np.random.default_rng(4).uniform(-1, 1, (3, 4, 300)).astype(np.float32))
    got_p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want_p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    got = fused.apply_fm_soa(got_p, coords)
    want = plain.apply_fm_soa(want_p, coords)
    got.square().sum().backward()
    want.square().sum().backward()
    assert_close(to_np(want), got, atol=1e-5)
    for k in params:
        assert_close(want_p[k].grad, got_p[k].grad, atol=1e-5, err_msg=k)


def test_fused_wrappers_reject_bad_shapes(enc):
    t = {k: torch.from_numpy(v) for k, v in _inputs((), 10, 5).items()}
    with pytest.raises(ValueError, match="w0"):
        permuto_cuda.encode_mlp_fwd(t["table"], t["w0"][:4], t["b0"], t["w1"], t["b1"], t["coords"], *_consts(enc))
    with pytest.raises(ValueError, match="b1"):
        permuto_cuda.encode_mlp_fwd(t["table"], t["w0"], t["b0"], t["w1"], t["b1"][:2], t["coords"], *_consts(enc))
    with pytest.raises(ValueError, match="g has shape"):
        permuto_cuda.encode_mlp_bwd(t["coords"], torch.zeros((8, 10)), t["g"][:2], t["w0"], t["b0"], t["w1"], *_consts(enc))
    # plain-version calls are not kernel launches
    before = dict(permuto_cuda.LAUNCHES)
    permuto_cuda.encode_mlp_fwd(*(t[k] for k in _ORDER), *_consts(enc))
    assert permuto_cuda.LAUNCHES == before
