"""The gather route of the permutohedral encoding against the JAX package.

``gather_pairs`` / ``table_grad`` (their plain versions on the CPU, which
the CUDA kernels are held against on the card) against the Pallas kernels
in interpret mode with f32 MXU operands; the ``gather_blend`` autograd
function against JAX's custom VJP; and what runs on the route: the
point-differentiable ``NeuralField.apply``, ``geometry_gradients`` and
``eikonal_term``, complex 2D rotations, and 2D field sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np

from neural_graph_mapping_tpu.models.fields import NeuralField as JaxField
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu.ops import losses as jlosses
from neural_graph_mapping_tpu.ops import permuto as jpermuto
from neural_graph_mapping_tpu.ops import permuto_pallas
from neural_graph_mapping_tpu.ops.encodings import PermutohedralEncoding as JaxEncoding
from neural_graph_mapping_tpu.utils import transforms as jtransforms
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.models.fields import NeuralField, NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops import losses, permuto, permuto_cuda
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding
from neural_graph_mapping_tpu_torch.utils import transforms

ENC_TYPE = "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding"


def _enc_kwargs(pos_dim):
    return dict(
        pos_dim=pos_dim, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
        coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2,
    )


# -- gather_pairs / table_grad against the Pallas kernels ----------------------


@pytest.mark.parametrize("lead,t,m", [
    ((3,), 256, 700), ((2, 4), 128, 300), ((1,), 256, 2048), ((2,), 256, 701), ((3,), 128, 1),
])
def test_gather_pairs_matches_pallas(lead, t, m):
    """Exact: a lookup moves values, it computes nothing."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=lead + (2, t)).astype(np.float32)
    idx = rng.integers(0, t, lead + (m,))
    want = permuto_pallas.gather_pairs(
        jnp.asarray(table), jnp.asarray(idx, jnp.int32), interpret=True, mxu_dtype=jnp.float32
    )
    got = permuto_cuda.gather_pairs(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == lead + (2, m)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("lead,t,m", [((2,), 128, 500), ((2, 3), 256, 700)])
def test_table_grad_matches_pallas(lead, t, m):
    """The histogram within 1e-4 (the JAX package's own tolerance for this
    kernel against np.add.at)."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, t, lead + (m,))
    gv = rng.normal(size=lead + (2, m)).astype(np.float32)
    want = permuto_pallas.table_grad(
        jnp.asarray(idx, jnp.int32), jnp.asarray(gv), t, interpret=True, mxu_dtype=jnp.float32
    )
    got = permuto_cuda.table_grad(torch.from_numpy(idx), torch.from_numpy(gv), t)
    assert got.shape == lead + (2, t)
    assert_close(want, got, atol=1e-4)


def test_table_grad_zero_gradients():
    idx = torch.zeros((1, 64), dtype=torch.int64)
    out = permuto_cuda.table_grad(idx, torch.zeros((1, 2, 64)), 128)
    assert out.shape == (1, 2, 128) and float(out.abs().max()) == 0.0


def test_gather_route_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        permuto_cuda.gather_pairs(torch.zeros((2, 2, 8)), torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        permuto_cuda.gather_pairs(torch.zeros((2, 2, 8)), torch.zeros((3, 5), dtype=torch.int64))
    with pytest.raises(ValueError):
        permuto_cuda.table_grad(torch.zeros((2, 5), dtype=torch.int64), torch.zeros((2, 2, 6)), 8)
    before = dict(permuto_cuda.LAUNCHES)
    permuto_cuda.gather_pairs(torch.zeros((2, 2, 8)), torch.zeros((2, 5), dtype=torch.int64))
    assert permuto_cuda.LAUNCHES == before  # plain versions launch nothing


# -- gather_blend: value and VJP ------------------------------------------------


@pytest.mark.parametrize("pos_dim", [3, 2])
def test_gather_blend_matches_jax_vjp(pos_dim):
    """Value within 1e-6; table and weight cotangents within 1e-5, against
    jax.vjp of JAX's custom-VJP gather_blend, on the lattice of 500 points."""
    je = JaxEncoding(**_enc_kwargs(pos_dim))
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 1.5, (pos_dim, 500)).astype(np.float32)
    table = rng.uniform(-1, 1, (2, 4, 256)).astype(np.float32)
    g = rng.normal(size=(8, 500)).astype(np.float32)
    idx, w = jpermuto.lattice_keys_and_weights_soa(
        tuple(jnp.asarray(p) for p in pts), jnp.asarray(je.scales), je._shifts,
        je._elev_scale, je.level_capacities,
    )
    want, vjp = jax.vjp(lambda t, ww: jpermuto.gather_blend(t, idx, ww), jnp.asarray(table), w)
    want_gt, want_gw = vjp(jnp.asarray(g))
    t_table = torch.from_numpy(table).requires_grad_(True)
    t_w = torch.from_numpy(np.array(w)).requires_grad_(True)
    got = permuto.gather_blend(t_table, torch.from_numpy(np.asarray(idx)).long(), t_w)
    got.backward(torch.from_numpy(g))
    assert_close(want, got, atol=1e-6)
    assert_close(want_gt, t_table.grad, atol=1e-5)
    assert_close(want_gw, t_w.grad, atol=1e-5)


def test_gather_blend_with_field_batch_matches_plain_autograd():
    """Leading field dims, and the autograd function against the plain
    blend's own autograd: identical values and gradients."""
    enc = PermutohedralEncoding(**_enc_kwargs(3))
    rng = np.random.default_rng(3)
    coords = torch.from_numpy(rng.uniform(-0.5, 1.5, (3, 3, 200)).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (3, 2, 4, 256)).astype(np.float32))
    idx, w = permuto.lattice_keys_and_weights_soa(
        coords.unbind(-2), enc.scales, enc.shifts, enc.elev_scale, enc.level_capacities
    )
    g = torch.from_numpy(rng.normal(size=(3, 8, 200)).astype(np.float32))
    results = []
    for fn in (permuto.gather_blend, permuto.gather_blend_plain):
        t, ww = table.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(t, idx, ww)
        out.backward(g)
        results.append((out.detach(), t.grad, ww.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos_dim", [3, 2])
def test_encoding_apply_and_apply_fm_match_jax(pos_dim):
    """PermutohedralEncoding.apply_fm (feature-major; the fused encode for
    3D) and apply (channels-last, the gather route; with a field batch)
    against JAX's on the CPU, within 1e-6."""
    je, te = JaxEncoding(**_enc_kwargs(pos_dim)), PermutohedralEncoding(**_enc_kwargs(pos_dim))
    rng = np.random.default_rng(12)
    tables = rng.uniform(-1, 1, (3, 2, 4, 256)).astype(np.float32)
    pts = rng.uniform(-0.5, 1.5, (3, 40, pos_dim)).astype(np.float32)
    for i in range(3):
        want = je.apply_fm({"table": jnp.asarray(tables[i])}, jnp.asarray(pts[i]))
        got = te.apply_fm({"table": torch.from_numpy(tables[i])}, torch.from_numpy(pts[i]))
        assert_close(want, got, atol=1e-6)
    want = np.stack([np.asarray(je.apply({"table": jnp.asarray(tables[i])}, jnp.asarray(pts[i]))) for i in range(3)])
    got = te.apply({"table": torch.from_numpy(tables)}, torch.from_numpy(pts))
    assert got.shape == (3, 40, 8)
    assert_close(want, got, atol=1e-6)


# -- complex rotations ------------------------------------------------------------


def test_complex_transforms_match_jax():
    rng = np.random.default_rng(4)
    theta = rng.uniform(-np.pi, np.pi, (5, 1))
    c = np.concatenate([np.cos(theta), np.sin(theta)], -1).astype(np.float32)  # (5, 2)
    a = rng.normal(size=(5, 7, 2)).astype(np.float32)
    pts = rng.normal(size=(5, 7, 2)).astype(np.float32)
    assert_close(jtransforms.complex_invert(jnp.asarray(c)), transforms.complex_invert(torch.from_numpy(c)), atol=0)
    assert_close(
        jtransforms.complex_multiply(jnp.asarray(a), jnp.asarray(pts)),
        transforms.complex_multiply(torch.from_numpy(a), torch.from_numpy(pts)), atol=1e-6,
    )
    got = transforms.complex_apply(torch.from_numpy(c)[:, None, :], torch.from_numpy(pts))
    assert_close(jtransforms.complex_apply(jnp.asarray(c)[:, None, :], jnp.asarray(pts)), got, atol=1e-6)
    # a rotation keeps lengths, and its conjugate undoes it
    assert_close(np.linalg.norm(pts, axis=-1), torch.linalg.norm(got, dim=-1), atol=1e-5)
    back = transforms.complex_apply(transforms.complex_invert(torch.from_numpy(c))[:, None, :], got)
    assert_close(pts, back, atol=1e-5)


# -- NeuralField.apply, geometry gradients, eikonal ------------------------------


def _fields(pos_dim=3, **kw):
    kwargs = dict(encoding_type=ENC_TYPE, encoding_kwargs=_enc_kwargs(pos_dim), num_layers=1, dim_out=4)
    kwargs.update(kw)
    return JaxField(**kwargs), NeuralField(**kwargs)


def _single_params(jf, seed, table_scale=100.0):
    params = {k: np.array(v) for k, v in jf.init(jax.random.PRNGKey(seed)).items()}
    params["enc.table"] = params["enc.table"] * table_scale
    if "rezero" in params:
        params["rezero"] = params["rezero"] + 0.5
    return params


@pytest.mark.parametrize("skip_mode", ["no", "add", "concat", "rezero"])
def test_field_apply_matches_jax(skip_mode):
    """Channels-last NeuralField.apply within 1e-5, all four skip modes
    (two hidden layers, so the skips act)."""
    jf, tf = _fields(num_layers=2, skip_mode=skip_mode)
    params = _single_params(jf, 5)
    pts = np.random.default_rng(5).uniform(-0.5, 1.5, (6, 50, 3)).astype(np.float32)
    want = jf.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts))
    got = tf.apply({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(pts))
    assert got.shape == (6, 50, 4)
    assert_close(want, got, atol=1e-5)


def test_geometry_gradients_and_eikonal_match_jax():
    """The production field shape (3D, 2 features a level, one hidden layer,
    no skip) at small width: JAX's geometry_gradients on the CPU against the
    port's, within 1e-5, and non-zero (the port's route is the gather
    route on every device); the eikonal term of both within 1e-5."""
    jf, tf = _fields()
    params = _single_params(jf, 6)
    pts = np.random.default_rng(6).uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jf.geometry_gradients(jp, jnp.asarray(pts))
    got = tf.geometry_gradients({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(pts))
    assert got.shape == (300, 3)
    assert_close(want, got, atol=1e-5)
    assert float(got.abs().max()) > 1e-2
    mask = np.arange(300) % 3 != 0
    assert_close(
        jlosses.eikonal_term(want, jnp.asarray(mask)),
        losses.eikonal_term(got, torch.from_numpy(mask)), atol=1e-5, rtol=1e-5,
    )
    assert_close(jlosses.eikonal_term(want), losses.eikonal_term(got), atol=1e-5, rtol=1e-5)


def test_geometry_gradients_of_a_field_batch():
    """Stacked parameters (4 fields) and points (4, P, 3): each field's
    gradients equal the single-field call; the fused training route (zero
    point gradient) is not what geometry_gradients takes."""
    jf, tf = _fields()
    tf_fused = NeuralField(ENC_TYPE, _enc_kwargs(3), num_layers=1, dim_out=4, fused_mlp=True)
    stacked = [_single_params(jf, 10 + i) for i in range(4)]
    params = {k: torch.from_numpy(np.stack([s[k] for s in stacked])) for k in stacked[0]}
    pts = torch.from_numpy(np.random.default_rng(7).uniform(-0.2, 1.2, (4, 100, 3)).astype(np.float32))
    got = tf_fused.geometry_gradients(params, pts)
    for i in range(4):
        want = tf.geometry_gradients({k: torch.from_numpy(v) for k, v in stacked[i].items()}, pts[i])
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-6)
    assert float(got.abs().max()) > 1e-2


# -- 2D field sets -----------------------------------------------------------------


def _field_set_kwargs(dim_points):
    return dict(
        dim_points=dim_points, field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=dict(encoding_type=ENC_TYPE, encoding_kwargs=_enc_kwargs(dim_points),
                          num_layers=1, dim_out=3),
        num_knn=2, distance_factor=10.0, outside_value=1.0, field_radius=1.0,
        scale_mode="unit_cube",
    )


def test_2d_field_set_apply_vmap_matches_jax():
    """A 2D permutohedral field set with non-identity complex orientations:
    apply_vmap values and every parameter gradient within 1e-5 of JAX on
    the CPU, the parameters carried across by interop.params_from_jax."""
    n, p = 3, 200
    jfs = JaxFieldSet(**_field_set_kwargs(2))
    tfs = NeuralFieldSet(**_field_set_kwargs(2))
    params = {k: np.asarray(v) for k, v in jfs.init_fields(jax.random.PRNGKey(8), n).items()}
    params["enc.table"] = params["enc.table"] * 100.0
    rng = np.random.default_rng(8)
    theta = rng.uniform(-np.pi, np.pi, (n, 1))
    ori = np.concatenate([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    pts = (pos[:, None, :] + rng.uniform(-1, 1, (n, p, 2))).astype(np.float32)
    g = rng.normal(size=(n, p, 3)).astype(np.float32)

    def jloss(prm):
        out = jfs.apply_vmap(prm, jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(ori))
        return jnp.sum(jnp.sin(out) * g), out

    (_, want), want_grads = jax.value_and_grad(jloss, has_aux=True)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: v.requires_grad_(True) for k, v in interop.params_from_jax(params, "cpu").items()}
    got = tfs.apply_vmap(tp, torch.from_numpy(pts), torch.from_numpy(pos), torch.from_numpy(ori))
    torch.sum(torch.sin(got) * torch.from_numpy(g)).backward()
    assert got.shape == (n, p, 3)
    assert_close(want, got, atol=1e-5)
    for k in params:
        assert_close(want_grads[k], tp[k].grad, atol=1e-5, err_msg=k)
    assert float(tp["enc.table"].grad.abs().max()) > 1e-3
    # the local frame: rotation by the conjugate, then the unit-cube scale
    local = tfs.world_to_local(torch.from_numpy(pts), torch.from_numpy(pos)[:, None], torch.from_numpy(ori)[:, None])
    want_local = jfs.world_to_local(jnp.asarray(pts), jnp.asarray(pos)[:, None], jnp.asarray(ori)[:, None])
    assert_close(want_local, local, atol=1e-6)


def test_field_set_dims_and_tiled_route():
    assert not NeuralFieldSet(**_field_set_kwargs(2)).supports_tiled_knn()
    assert NeuralFieldSet(**_field_set_kwargs(3)).supports_tiled_knn()
    with pytest.raises(NotImplementedError):
        NeuralFieldSet(**{**_field_set_kwargs(3), "dim_points": 4})


def test_3d_field_set_apply_vmap_matches_jax():
    """apply_vmap of a 3D set (quaternion poses) on the gather route, 1e-5."""
    n, p = 2, 150
    jfs = JaxFieldSet(**_field_set_kwargs(3))
    tfs = NeuralFieldSet(**_field_set_kwargs(3))
    params = {k: np.asarray(v) for k, v in jfs.init_fields(jax.random.PRNGKey(9), n).items()}
    params["enc.table"] = params["enc.table"] * 100.0
    rng = np.random.default_rng(9)
    q = rng.normal(size=(n, 4))
    ori = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    pts = (pos[:, None, :] + rng.uniform(-1, 1, (n, p, 3))).astype(np.float32)
    want = jfs.apply_vmap({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pts),
                          jnp.asarray(pos), jnp.asarray(ori))
    got = tfs.apply_vmap(interop.params_from_jax(params, "cpu"), torch.from_numpy(pts),
                         torch.from_numpy(pos), torch.from_numpy(ori))
    assert_close(want, got, atol=1e-5)
