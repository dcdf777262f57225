"""Carry state across from the JAX package.

Both packages store the same layouts (stacked per-field parameters with a
leading field axis, feature-major (N, F, L, T) hash tables, the same map
registry), so these functions only validate and move arrays. They raise on
any other layout, as the JAX package's checkpoint loader does for tables
saved level-major.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from neural_graph_mapping_tpu_torch.mapping import map_state, optimizer

_LINEAR = re.compile(r"^([wb])(\d+)$")


# features per level: the only count the encode kernels take
_FEATURES = 2
# each encoding's parameter leaf -> (its dims with the field axis, its layout)
_ENCODING_LEAVES = {
    "enc.table": (4, f"(N, F={_FEATURES}, L, T) (feature-major)"),
    "enc.planes": (5, "(N, 3, C, R, R)"),
    "enc.fourier_w": (3, "(N, dim_in, n)"),
}


def _check_params(params: Dict[str, np.ndarray]) -> int:
    """Validate a stacked field-parameter dict; returns the field count.

    The encoding's leaves are one of ``enc.table`` (permutohedral),
    ``enc.planes`` (triplane), ``enc.fourier_w`` (Fourier) or none (NeRF
    octaves); ``w0`` must be there."""
    enc = [k for k in params if k.startswith("enc.")]
    if len(enc) > 1:
        raise ValueError(f"params hold more than one encoding leaf: {enc}")
    if "w0" not in params:
        raise ValueError("params lack 'w0'")
    n = None
    linears: Dict[str, Dict[int, np.ndarray]] = {"w": {}, "b": {}}
    for key, value in params.items():
        value = np.asarray(value)
        if n is None:
            n = value.shape[0] if value.ndim else -1
        if value.ndim == 0 or value.shape[0] != n:
            raise ValueError(f"{key}: every leaf needs the same leading field axis ({n})")
        match = _LINEAR.match(key)
        if key in _ENCODING_LEAVES:
            ndim, layout = _ENCODING_LEAVES[key]
            bad = value.ndim != ndim
            if key == "enc.table":
                bad = bad or value.shape[1] != _FEATURES
            elif key == "enc.planes":
                bad = bad or value.shape[1] != 3 or value.shape[3] != value.shape[4]
            if bad:
                raise ValueError(f"{key} has shape {value.shape}; expected {layout}")
        elif match:
            want_ndim = 3 if match.group(1) == "w" else 2
            if value.ndim != want_ndim:
                raise ValueError(f"{key} must have {want_ndim} dims, got {value.shape}")
            linears[match.group(1)][int(match.group(2))] = value
        elif key == "rezero":
            if value.ndim != 2:
                raise ValueError(f"rezero must be (N, num_layers), got {value.shape}")
        elif key == "neus_sd":
            if value.ndim != 1:
                raise ValueError(f"neus_sd must be (N,), got {value.shape}")
        else:
            raise ValueError(f"unknown parameter {key!r}")
    if sorted(linears["w"]) != sorted(linears["b"]) or sorted(linears["w"]) != list(range(len(linears["w"]))):
        raise ValueError("linears must be w0..wK with matching b0..bK")
    for i, w in linears["w"].items():
        if linears["b"][i].shape[1] != w.shape[2]:
            raise ValueError(f"b{i} {linears['b'][i].shape} does not match w{i} {w.shape}")
    return n


def params_from_jax(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """JAX stacked params (numpy) -> the port's dict on ``device``.

    Keys: the encoding's leaf, ``enc.table`` (N, F, L, T), ``enc.planes``
    (N, 3, C, R, R), ``enc.fourier_w`` (N, dim_in, n) or none; ``w{i}``
    (N, din, dout), ``b{i}`` (N, dout), optionally ``rezero`` (N, layers)
    and ``neus_sd`` (N,).
    """
    _check_params(params)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device) for k, v in params.items()}


def adam_from_jax(
    m: Dict[str, np.ndarray], v: Dict[str, np.ndarray], steps: np.ndarray, device
) -> optimizer.AdamState:
    """JAX ``AdamState`` leaves (numpy) -> the port's AdamState on ``device``."""
    n_m = _check_params(m)
    n_v = _check_params(v)
    steps = np.asarray(steps)
    if set(m) != set(v) or any(np.shape(m[k]) != np.shape(v[k]) for k in m):
        raise ValueError("Adam moments m and v must have the same keys and shapes")
    if steps.shape != (n_m,) or n_m != n_v:
        raise ValueError(f"steps must be ({n_m},), got {steps.shape}")
    return optimizer.AdamState(
        m=params_from_jax(m, device),
        v=params_from_jax(v, device),
        steps=torch.tensor(steps, dtype=torch.int32, device=device),
    )


def map_arrays_from_jax(
    positions: np.ndarray,
    orientations: np.ndarray,
    kf_ids: np.ndarray,
    kf_slots: np.ndarray,
    training_iterations: np.ndarray,
    device,
) -> map_state.MapArrays:
    """JAX ``MapArrays`` leaves (numpy) -> the port's MapArrays on ``device``."""
    cap = np.shape(positions)[0]
    shapes = {
        "positions": (np.shape(positions), (cap, 3)),
        "orientations": (np.shape(orientations), (cap, 4)),
        "kf_ids": (np.shape(kf_ids), (cap,)),
        "kf_slots": (np.shape(kf_slots), (cap,)),
        "training_iterations": (np.shape(training_iterations), (cap,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(got)}")

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    return map_state.MapArrays(
        positions=f32(positions),
        orientations=f32(orientations),
        kf_ids=i32(kf_ids),
        kf_slots=i32(kf_slots),
        training_iterations=i32(training_iterations),
    )
