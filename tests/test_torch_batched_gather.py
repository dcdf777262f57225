"""Parity of the port's batched_gather (plain version on CPU) with the JAX
Pallas kernel in interpret mode and with exact indexing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

from neural_graph_mapping_tpu.ops import permuto_pallas
from neural_graph_mapping_tpu_torch.ops import permuto_cuda


@pytest.mark.parametrize("b,n,m", [(3, 4800, 640), (2, 128, 50), (1, 300, 1024)])
def test_matches_pallas_interpret_and_indexing(b, n, m):
    """Exact (tolerance 0): a gather moves values, it computes nothing."""
    rng = np.random.default_rng(b * 1000 + m)
    values = rng.normal(size=(b, n)).astype(np.float32)
    idx = rng.integers(0, n, (b, m))
    want = permuto_pallas.batched_gather(
        jnp.asarray(values), jnp.asarray(idx, jnp.int32), interpret=True
    )
    got = permuto_cuda.batched_gather(torch.from_numpy(values), torch.from_numpy(idx))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got), np.take_along_axis(values, idx, axis=1))


def test_rejects_bad_inputs():
    values = torch.zeros((2, 10))
    with pytest.raises(TypeError):
        permuto_cuda.batched_gather(values, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError):
        permuto_cuda.batched_gather(values.double(), torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        permuto_cuda.batched_gather(values, torch.zeros((3, 3), dtype=torch.int64))


def test_visibility_depths_are_exact_cpu_semantics():
    """sampling._visibility_depths reads the exact cached depth (the JAX CPU
    path's semantics), through the batched_gather wrapper."""
    from neural_graph_mapping_tpu.mapping import sampling as jsampling
    from neural_graph_mapping_tpu_torch.mapping import sampling

    rng = np.random.default_rng(7)
    s, h, w, f, k = 5, 12, 16, 3, 20
    depth = rng.uniform(0, 4, (s, h, w)).astype(np.float32)
    ys = rng.integers(0, h, (f, k, s))
    xs = rng.integers(0, w, (f, k, s))
    want = jsampling._visibility_depths(
        jnp.asarray(depth), jnp.asarray(ys, jnp.int32), jnp.asarray(xs, jnp.int32)
    )
    got = sampling._visibility_depths(
        torch.from_numpy(depth), torch.from_numpy(ys), torch.from_numpy(xs)
    )
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
