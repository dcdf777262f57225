"""Parity of the port's encoding module and field models with the JAX
package, on weights carried across by interop.params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, to_np

from neural_graph_mapping_tpu.models.fields import NeuralField as JaxField
from neural_graph_mapping_tpu.models.fields import NeuralFieldSet as JaxFieldSet
from neural_graph_mapping_tpu.ops.encodings import PermutohedralEncoding as JaxEncoding
from neural_graph_mapping_tpu_torch import interop
from neural_graph_mapping_tpu_torch.models.fields import NeuralField, NeuralFieldSet
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

ENC = "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding"
ENC_KW = dict(
    pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=2,
    coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-1,
)


@pytest.mark.parametrize(
    "kw",
    [
        ENC_KW,
        dict(ENC_KW, log2_hashmap_size=12, nr_levels=16, finest_scale=1e-4),
        dict(ENC_KW, shift_seed=3, appply_random_shift_per_level=True),
        dict(ENC_KW, per_level_capacities=False),
    ],
    ids=["small", "production", "seed3", "uniform_caps"],
)
def test_encoding_constants_equal(kw):
    je, te = JaxEncoding(**kw), PermutohedralEncoding(**kw)
    np.testing.assert_array_equal(te.scales.numpy(), je.scales)
    np.testing.assert_array_equal(te.shifts.numpy(), np.asarray(je._shifts))
    np.testing.assert_array_equal(te.elev_scale.numpy(), np.asarray(je._elev_scale))
    assert te.level_capacities == je.level_capacities
    assert te._scales_t == je._scales_t
    assert te._shifts_t == je._shifts_t
    assert te._elev_t == je._elev_t
    assert te.get_out_dim() == je.get_out_dim()


def _field_kwargs(skip_mode, num_layers=2):
    return dict(
        encoding_type=ENC, encoding_kwargs=ENC_KW, num_layers=num_layers, dim_out=4,
        skip_mode=skip_mode, initial_geometry_bias=0.5, neus_initial_sd=0.3,
    )


@pytest.mark.parametrize("skip_mode", ["no", "add", "concat", "rezero"])
def test_field_apply_fm_soa(skip_mode):
    """NeuralField.apply_fm_soa within 1e-5 (skip modes all four; rezero
    gains drawn nonzero so the skip path matters)."""
    jf = JaxField(**_field_kwargs(skip_mode))
    tf = NeuralField(**_field_kwargs(skip_mode))
    params = {k: np.asarray(v) for k, v in jf.init(jax.random.PRNGKey(0)).items()}
    if skip_mode == "rezero":
        params["rezero"] = np.asarray([0.7, -0.4], np.float32)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, 1.2, (3, 600)).astype(np.float32)
    want = jf.apply_fm_soa({k: jnp.asarray(v) for k, v in params.items()},
                           tuple(jnp.asarray(p) for p in pts))
    stacked = interop.params_from_jax({k: v[None] for k, v in params.items()}, "cpu")
    got = tf.apply_fm_soa({k: v[0] for k, v in stacked.items()}, tuple(torch.from_numpy(p) for p in pts))
    assert got.shape == (4, 600)
    assert_close(want, got, atol=1e-5)


def _fieldset_kwargs():
    return dict(
        dim_points=3,
        field_type="neural_graph_mapping_tpu.models.fields.NeuralField",
        field_kwargs=_field_kwargs("no", num_layers=1),
        num_knn=2, distance_factor=10.0, outside_value=1.0, field_radius=1.0,
        scale_mode="unit_cube",
    )


def test_fieldset_apply_vmap_fm_soa():
    """Field-parallel evaluation (vmap in JAX, a batch dimension and bmm in
    the port) within 1e-5; posed fields, world coordinates."""
    jfs, tfs = JaxFieldSet(**_fieldset_kwargs()), NeuralFieldSet(**_fieldset_kwargs())
    f, p = 3, 500
    params = {k: np.asarray(v) for k, v in jfs.init_fields(jax.random.PRNGKey(1), f).items()}
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (f, 3)).astype(np.float32)
    quat = rng.normal(size=(f, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    coords = rng.uniform(-1.5, 1.5, (3, f, p)).astype(np.float32)
    want = jfs.apply_vmap_fm_soa(
        {k: jnp.asarray(v) for k, v in params.items()},
        tuple(jnp.asarray(c) for c in coords), jnp.asarray(pos), jnp.asarray(quat),
    )
    got = tfs.apply_vmap_fm_soa(
        interop.params_from_jax(params, "cpu"),
        tuple(torch.from_numpy(c) for c in coords), torch.from_numpy(pos), torch.from_numpy(quat),
    )
    assert got.shape == (f, 4, p)
    assert_close(want, got, atol=1e-5)
    # gather_fields selects the same slices
    ids = np.array([2, 0, 2])
    want_g = jfs.gather_fields({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(ids))
    got_g = tfs.gather_fields(interop.params_from_jax(params, "cpu"), torch.from_numpy(ids))
    for k in params:
        np.testing.assert_array_equal(to_np(got_g[k]), np.asarray(want_g[k]))


def test_init_layout_matches_jax():
    """The port's init makes the JAX package's keys, shapes and bias."""
    jfs, tfs = JaxFieldSet(**_fieldset_kwargs()), NeuralFieldSet(**_fieldset_kwargs())
    want = jfs.init_fields(jax.random.PRNGKey(0), 5)
    got = tfs.init_fields(5, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    bound = 1.0 / np.sqrt(8)  # fan-in: 4 levels x 2 features
    assert float(got["w0"].abs().max()) <= bound
    assert float(got["enc.table"].abs().max()) <= ENC_KW["init_scale"]
    b_last = got["b1"][:, -1].numpy()
    assert ((b_last >= 0.5 - 0.25) & (b_last <= 0.5 + 0.25)).all()


def test_params_from_jax_rejects_other_layouts():
    params = {
        "enc.table": np.zeros((2, 2, 4, 256), np.float32),
        "w0": np.zeros((2, 8, 8), np.float32), "b0": np.zeros((2, 8), np.float32),
        "w1": np.zeros((2, 8, 4), np.float32), "b1": np.zeros((2, 4), np.float32),
    }
    interop.params_from_jax(params, "cpu")
    # level-major tables, (N, L, F, T) and (N, L, T, F), and a 3-D one
    for shape in [(2, 4, 2, 256), (2, 4, 256, 2), (2, 2, 1024)]:
        with pytest.raises(ValueError, match="feature-major"):
            interop.params_from_jax(dict(params, **{"enc.table": np.zeros(shape, np.float32)}), "cpu")
    with pytest.raises(ValueError, match="feature-major"):  # the same guard for Adam moments
        bad = dict(params, **{"enc.table": np.zeros((2, 4, 256, 2), np.float32)})
        interop.adam_from_jax(bad, bad, np.zeros((2,), np.int32), "cpu")
    with pytest.raises(ValueError, match="unknown"):
        interop.params_from_jax(dict(params, extra=np.zeros((2,))), "cpu")
    with pytest.raises(ValueError, match="leading field axis"):
        interop.params_from_jax(dict(params, b1=np.zeros((3, 4), np.float32)), "cpu")
    with pytest.raises(ValueError, match="w0..wK"):
        interop.params_from_jax({k: v for k, v in params.items() if k != "b1"}, "cpu")
    with pytest.raises(ValueError, match="must have 3 dims"):
        interop.params_from_jax(dict(params, w0=np.zeros((2, 8), np.float32)), "cpu")
