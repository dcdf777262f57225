"""A permutohedral field with F != 2 features a level against the JAX package.

The fused encode takes 2 features a level, so such a field runs on the
gather route everywhere: ``gather_pairs`` / ``table_grad`` (on the card the
kernels of rows 7-8 at this F, here their plain versions) inside
``gather_blend``. Against JAX's CPU path (``lattice_keys_and_weights_soa`` +
its custom-VJP ``gather_blend``) on the same tables: output within 1e-5
absolute, table gradient within 1e-4 relative to its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from neural_graph_mapping_tpu.models.fields import NeuralField as JaxField
from neural_graph_mapping_tpu.ops.encodings import PermutohedralEncoding as JaxEncoding
from neural_graph_mapping_tpu_torch.models.fields import NeuralField
from neural_graph_mapping_tpu_torch.ops import permuto_cuda
from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

ENC_TYPE = "neural_graph_mapping_tpu.ops.encodings.PermutohedralEncoding"


def _enc_kwargs(n_feat):
    return dict(
        pos_dim=3, log2_hashmap_size=8, nr_levels=4, nr_feat_per_level=n_feat,
        coarsest_scale=1.0, finest_scale=0.01, init_scale=1e-2,
    )


@pytest.mark.parametrize("n_feat", [1, 4])
def test_encoding_output_and_table_gradient_match_jax(n_feat):
    je = JaxEncoding(**_enc_kwargs(n_feat))
    te = PermutohedralEncoding(**_enc_kwargs(n_feat))
    assert not te._uses_fused()
    rng = np.random.default_rng(30 + n_feat)
    table = rng.uniform(-1, 1, (n_feat, 4, je.capacity)).astype(np.float32)
    pts = rng.uniform(-0.5, 1.5, (700, 3)).astype(np.float32)
    g = rng.normal(size=(4 * n_feat, 700)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: je.apply_fm({"table": t}, jnp.asarray(pts)), jnp.asarray(table))
    (want_gt,) = vjp(jnp.asarray(g))
    t_table = torch.from_numpy(table).requires_grad_(True)
    before = dict(permuto_cuda.LAUNCHES)
    got = te.apply_fm({"table": t_table}, torch.from_numpy(pts))
    got.backward(torch.from_numpy(g))
    assert permuto_cuda.LAUNCHES == before  # the CPU takes the plain versions
    assert got.shape == (4 * n_feat, 700)
    assert_close(want, got, atol=1e-5)
    scale = float(np.abs(np.asarray(want_gt)).max())
    assert_close(want_gt, t_table.grad, atol=1e-4 * scale)


@pytest.mark.parametrize("n_feat", [1, 4])
def test_field_output_and_table_gradient_match_jax(n_feat):
    """A whole NeuralField (encoding + MLP) on the same weights: outputs and
    the loss's table gradient, the port against jax.grad."""
    kw = dict(encoding_type=ENC_TYPE, encoding_kwargs=_enc_kwargs(n_feat), num_layers=1, dim_out=4)
    jf, tf = JaxField(**kw), NeuralField(**kw)
    params = {k: np.array(v) for k, v in jf.init(jax.random.PRNGKey(n_feat)).items()}
    params["enc.table"] = params["enc.table"] * 100.0  # away from init's tiny scale
    rng = np.random.default_rng(40 + n_feat)
    pts = rng.uniform(-0.5, 1.5, (500, 3)).astype(np.float32)
    target = rng.normal(size=(500, 4)).astype(np.float32)

    def jloss(p):
        return jnp.sum((jf.apply(p, jnp.asarray(pts)) - target) ** 2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jf.apply(jp, jnp.asarray(pts))
    want_g = jax.grad(jloss)(jp)
    tparams = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
    got = tf.apply(tparams, torch.from_numpy(pts))
    loss = torch.sum((got - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert_close(want, got, atol=1e-5)
    jt = np.asarray(want_g["enc.table"])
    scale = float(np.abs(jt).max())
    assert_close(jt, tparams["enc.table"].grad, atol=1e-4 * scale)
