"""Name resolution for the frozen copy's model config (the part of
``neural_graph_mapping_tpu_torch.config`` that the fields use)."""

from __future__ import annotations

from pydoc import locate
from typing import Any

# Config files name their classes under the JAX package or the port; both
# resolve to this copy's class of the same module path and name.
_PREFIXES = ("neural_graph_mapping_tpu_torch.", "neural_graph_mapping_tpu.")
PACKAGE_PREFIX = "port_bench.reference.ngm."


def str_to_object(name: str) -> Any:
    """Resolve a fully-qualified name to an object of this copy."""
    for prefix in _PREFIXES:
        if name.startswith(prefix):
            name = PACKAGE_PREFIX + name[len(prefix):]
            break
    obj = locate(name)
    if obj is None:
        raise ImportError(f"Could not locate object {name!r}")
    return obj
