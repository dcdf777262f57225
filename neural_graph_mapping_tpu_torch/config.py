"""Layered YAML configuration (port of neural_graph_mapping_tpu.config).

The loader reads the same ``config/*.yaml`` files as the JAX package. Class
paths in them name the JAX package (``neural_graph_mapping_tpu.…``);
:func:`str_to_object` maps that prefix to this package, so one YAML file
drives both. ``yaml`` is imported inside the loader only: a machine that runs
the port from a literal config dict needs no PyYAML.
"""

from __future__ import annotations

import copy
import os
from pydoc import locate
from typing import Any, Iterable, Optional, Union

PACKAGE_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config")

DEFAULT_SEARCH_PATHS = [
    "",  # current working dir
    os.path.normpath(PACKAGE_CONFIG_DIR),
]

JAX_PACKAGE_PREFIX = "neural_graph_mapping_tpu."
PACKAGE_PREFIX = "neural_graph_mapping_tpu_torch."


def resolve_path(path: str, search_paths: Optional[Iterable[str]] = None) -> str:
    """Resolve a (possibly relative) path against a list of search dirs."""
    path = os.path.expanduser(str(path))
    if os.path.isabs(path) and os.path.isfile(path):
        return path
    for base in search_paths if search_paths is not None else DEFAULT_SEARCH_PATHS:
        candidate = os.path.join(os.path.expanduser(base), path)
        if os.path.isfile(candidate):
            return os.path.normpath(candidate)
    raise FileNotFoundError(f"Could not resolve config file {path!r}")


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge override into base (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _expand_env(x: Any) -> Any:
    """Recursively expand ${VAR} in string values (used for data roots)."""
    if isinstance(x, dict):
        return {k: _expand_env(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_expand_env(v) for v in x]
    if isinstance(x, str):
        return os.path.expandvars(x)
    return x


def _load_file(path: str, search_paths: Optional[Iterable[str]]) -> dict:
    import yaml

    resolved = resolve_path(path, search_paths)
    with open(resolved) as f:
        data = _expand_env(yaml.safe_load(f) or {})
    # a file may pull in parent configs via a `config` key; parents first
    file_dir = os.path.dirname(resolved)
    local_search = [file_dir] + list(search_paths or DEFAULT_SEARCH_PATHS)
    return _expand_config_keys(data, local_search)


def _expand_config_keys(data: dict, search_paths: Iterable[str]) -> dict:
    if "config" not in data:
        return data
    parents = data.pop("config")
    if isinstance(parents, (str, os.PathLike)):
        parents = [parents]
    merged: dict = {}
    for parent in parents:
        merged = _deep_merge(merged, _load_file(parent, search_paths))
    return _deep_merge(merged, data)


def load_config(
    config: Union[str, os.PathLike, dict, None],
    current_dict: Optional[dict] = None,
    search_paths: Optional[Iterable[str]] = None,
) -> dict:
    """Merge a config (file path or dict) on top of ``current_dict``."""
    merged = copy.deepcopy(current_dict) if current_dict else {}
    if config is None:
        return merged
    if isinstance(config, (str, os.PathLike)):
        data = _load_file(str(config), search_paths)
    else:
        data = _expand_config_keys(
            copy.deepcopy(dict(config)), search_paths or DEFAULT_SEARCH_PATHS
        )
    return _deep_merge(merged, data)


def str_to_object(name: str) -> Any:
    """Resolve a fully-qualified name to an object, importing as needed.

    Names under the JAX package resolve to their counterpart in this package
    (same module path and class name), so the shared YAML files work here.
    """
    if name.startswith(JAX_PACKAGE_PREFIX):
        name = PACKAGE_PREFIX + name[len(JAX_PACKAGE_PREFIX):]
    obj = locate(name)
    if obj is None:
        raise ImportError(f"Could not locate object {name!r}")
    return obj
