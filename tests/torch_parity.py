"""Helpers for the PyTorch port's parity tests.

A parity test makes its inputs with numpy from a seed, runs the JAX function
and its port on them, and compares the results as numpy arrays. JAX stays on
the CPU (tests/conftest.py); the port runs on the CPU here, where its kernel
wrappers take their plain PyTorch versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

# six xdist workers share the machine: keep each worker's torch pool small
torch.set_num_threads(2)


def to_np(x):
    """jax / torch array (or a dict / NamedTuple / tuple of them) -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_np(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    return np.asarray(x)


def to_torch(x, dtype=None):
    """numpy / jax array (or a dict / NamedTuple of them) -> CPU torch tensor."""
    if isinstance(x, dict):
        return {k: to_torch(v, dtype) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_torch(v, dtype) for v in x))
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_jax(x):
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    return jnp.asarray(np.asarray(x))


def run_both(jax_fn, torch_fn, *inputs):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy inputs; returns both
    results as numpy."""
    got_jax = jax_fn(*(to_jax(a) for a in inputs))
    got_torch = torch_fn(*(to_torch(a) for a in inputs))
    return to_np(got_jax), to_np(got_torch)


def assert_close(want, got, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(
        np.asarray(to_np(got), dtype=np.float64), np.asarray(to_np(want), dtype=np.float64),
        atol=atol, rtol=rtol, err_msg=err_msg,
    )
