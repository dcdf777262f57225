"""Per-field Adam with gather/scatter slice updates (port of
neural_graph_mapping_tpu.mapping.optimizer).

The optimizer state mirrors the stacked field parameters (leading field axis)
plus a per-field step counter. :func:`adam_slice_update` steps the gathered
slice and writes it back IN PLACE into the full parameter and state tensors
(saving a copy of every stacked tensor per iteration).

One deliberate difference from the JAX package: only VALID slots are written
back. ``select_target_fields`` points invalid slots at field 0, and the JAX
``adam_slice_update`` scatters every slot, so an invalid slot can overwrite
field 0's fresh update with its stale value. Here each invalid slot writes
the same row as a valid slot (the first one) with that slot's new values, so
duplicate writes agree and field 0 keeps its update.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AdamConfig(NamedTuple):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15  # reference config adam_eps (neural_graph_map.yaml)
    weight_decay: float = 1e-5  # reference adam_weight_decay


class AdamState(NamedTuple):
    m: dict  # same keys and shapes as params (leading field axis)
    v: dict
    steps: torch.Tensor  # (num_fields,) int32


def init_adam_state(params: dict) -> AdamState:
    n = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    return AdamState(
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)])


def grow_adam_state(state: AdamState, grown_params: dict) -> AdamState:
    """Pad optimizer state to a grown field capacity (new slots zeroed)."""
    n = next(iter(grown_params.values())).shape[0]
    return AdamState(
        m={k: _pad_rows(t, n) for k, t in state.m.items()},
        v={k: _pad_rows(t, n) for k, t in state.v.items()},
        steps=_pad_rows(state.steps, n),
    )


def _expand(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (F,) vector over a (F, ...) tensor."""
    return x.reshape(tuple(x.shape) + (1,) * (like.ndim - 1))


@torch.no_grad()
def adam_slice_update(
    cfg: AdamConfig,
    params: dict,
    state: AdamState,
    field_ids: torch.Tensor,  # (F,)
    field_valid: torch.Tensor,  # (F,)
    grads: dict,  # gathered-slice grads, leading axis F
    sub_params: dict,  # gathered slice of params (leading axis F)
) -> Tuple[dict, AdamState]:
    """Adam step (torch semantics: weight decay folded into the gradient) on
    the gathered slice, written back in place; invalid slots change nothing.
    Returns the (updated) ``params`` and ``state``."""
    sub_steps = state.steps[field_ids]
    new_steps = sub_steps + field_valid.to(torch.int32)
    t = torch.clamp(new_steps, min=1).float()
    bc1 = 1.0 - cfg.beta1**t
    bc2 = 1.0 - cfg.beta2**t

    # write-back sources: a valid slot writes itself; an invalid slot repeats
    # the first valid slot (or, with none valid, slot 0's unchanged values)
    first_valid = torch.argmax(field_valid.to(torch.int32))
    src = torch.where(field_valid, torch.arange(field_ids.shape[0], device=field_ids.device), first_valid)
    dst = field_ids[src].long()

    for k, p in sub_params.items():
        g = grads[k] + cfg.weight_decay * p
        m = state.m[k][field_ids]
        v = state.v[k][field_ids]
        m_new = cfg.beta1 * m + (1.0 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1.0 - cfg.beta2) * g * g
        m_hat = m_new / _expand(bc1, m_new)
        v_hat = v_new / _expand(bc2, v_new)
        p_new = p - cfg.learning_rate * m_hat / (torch.sqrt(v_hat) + cfg.eps)
        ok = _expand(field_valid, p)
        p_new = torch.where(ok, p_new, p)
        m_new = torch.where(ok, m_new, m)
        v_new = torch.where(ok, v_new, v)
        params[k].index_copy_(0, dst, p_new[src])
        state.m[k].index_copy_(0, dst, m_new[src])
        state.v[k].index_copy_(0, dst, v_new[src])
    state.steps.index_copy_(0, dst, torch.where(field_valid, new_steps, sub_steps)[src])
    return params, state
