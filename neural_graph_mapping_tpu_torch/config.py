"""Layered YAML configuration with dotted CLI overrides (port of
neural_graph_mapping_tpu.config).

The loader reads the same ``config/*.yaml`` files as the JAX package. Class
paths in them name the JAX package (``neural_graph_mapping_tpu.…``);
:func:`str_to_object` maps that prefix to this package, so one YAML file
drives both. ``yaml`` is imported only to read a config file: a machine
without PyYAML reads config files written as JSON (which is YAML). Overrides
go through this module's own YAML-scalar parser, and configs are written as
JSON, so both are the same with or without PyYAML.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pathlib
import re
from pydoc import locate
from typing import Any, Iterable, List, Optional, Sequence, Union

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
    resolved = resolve_path(path, search_paths)
    with open(resolved) as f:
        try:
            import yaml
        except ImportError:  # JSON is YAML: without PyYAML, JSON configs still load
            data = json.load(f)
        else:
            data = yaml.safe_load(f)
    data = _expand_env(data or {})
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


def _set_dotted(config: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = config
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot override non-dict key {k} in {dotted_key}")
    node[keys[-1]] = value


def load_config_from_args(
    argv: Optional[Sequence[str]] = None,
    search_paths: Optional[Iterable[str]] = None,
    default_config: Optional[List[str]] = None,
) -> dict:
    """Parse ``--config a.yaml b.yaml`` + dotted overrides from argv.

    Config files merge left to right, then every ``--key.subkey value`` pair
    overrides, with values parsed as YAML (so numbers, bools and lists work).
    """
    parser = argparse.ArgumentParser(description="Run mapping.", allow_abbrev=False)
    parser.add_argument("--config", default=default_config or [], nargs="+")
    known, unknown = parser.parse_known_args(argv)

    config: dict = {}
    for path in known.config:
        config = _deep_merge(config, _load_file(path, search_paths))

    i = 0
    while i < len(unknown):
        arg = unknown[i]
        if not arg.startswith("--"):
            raise ValueError(f"Unexpected argument {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(unknown):
                raise ValueError(f"Missing value for override {arg!r}")
            raw = unknown[i + 1]
            i += 2
        _set_dotted(config, key, _parse_override_value(raw))
    return config


def _parse_override_value(raw: str) -> Any:
    """Parse a CLI override as YAML 1.1 does, with a float fallback for
    exponent notation like ``1e-3`` that YAML 1.1 treats as a string.

    The parser is this module's own, so a machine without PyYAML gives the
    same value: null / bool words in any of YAML's spellings, decimal ints,
    floats, quoted strings and flow lists / maps of these. A spelling whose
    YAML meaning it does not reproduce (octal, hex, sexagesimal, dates,
    anchors, tags, an unbalanced flow collection) raises ``ValueError``.
    """
    text = raw.strip()
    if text[:1] and text[0] in "[{'\"":
        try:
            value, end = _flow_node(text, 0)
        except IndexError:
            raise ValueError(f"Unclosed bracket or quote in override {raw!r}") from None
        if text[end:].strip():
            raise ValueError(f"Trailing text in override {raw!r}")
    else:
        value = _plain_scalar(text)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


_YAML_NULLS = ("", "~", "null", "Null", "NULL")
_YAML_BOOLS = {
    w: v
    for v, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
    for word in words
    for w in (word, word.capitalize(), word.upper())
}
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(
    r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
)
_YAML_INF_NAN = re.compile(r"([-+]?)\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# int / float / timestamp forms of YAML 1.1 that this parser does not reproduce
_YAML_UNSUPPORTED = re.compile(
    r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"
)


def _plain_scalar(token: str) -> Any:
    token = token.strip()
    if token in _YAML_NULLS:
        return None
    if token in _YAML_BOOLS:
        return _YAML_BOOLS[token]
    if _YAML_INT.fullmatch(token):
        return int(token.replace("_", ""))
    if _YAML_FLOAT.fullmatch(token):
        return float(token.replace("_", ""))
    special = _YAML_INF_NAN.fullmatch(token)
    if special:
        return float(special.group(0).lower().replace(".", ""))
    if (
        _YAML_UNSUPPORTED.fullmatch(token)
        or token[0] in "&*!|>%@`#"
        or token in ("-", "?")
        or token[:2] in ("- ", "? ")
        or ": " in token
        or " #" in token
        or token.endswith(":")
    ):
        raise ValueError(f"Override value {token!r} has a YAML form this parser does not read")
    return token


def _quoted(text: str, i: int) -> tuple:
    """The quoted scalar starting at ``text[i]`` and the index after it."""
    quote = text[i]
    j = i + 1
    while True:
        if quote == '"' and text[j] == "\\":
            j += 2  # an escape, decoded below
        elif text[j] == quote and quote == "'" and text[j + 1 : j + 2] == "'":
            j += 2  # '' is an escaped quote
        elif text[j] == quote:
            break
        else:
            j += 1
    body = text[i + 1 : j]
    value = body.replace("''", "'") if quote == "'" else json.loads(f'"{body}"')
    return value, j + 1


def _skip_space(text: str, i: int) -> int:
    while text[i] == " ":
        i += 1
    return i


def _flow_node(text: str, i: int) -> tuple:
    """The flow collection or scalar starting at ``text[i]`` and the index
    after it; runs off the end (``IndexError``) when a bracket is open."""
    i = _skip_space(text, i)
    opener = text[i]
    if opener in "'\"":
        return _quoted(text, i)
    if opener not in "[{":
        j = i
        while text[j] not in ",[]{}" and not (text[j] == ":" and text[j + 1] in " ,]}"):
            j += 1
        return _plain_scalar(text[i:j]), j
    closer = "]" if opener == "[" else "}"
    items: Any = [] if opener == "[" else {}
    i = _skip_space(text, i + 1)
    while text[i] != closer:
        node, i = _flow_node(text, i)
        i = _skip_space(text, i)
        if opener == "{":
            value = None
            if text[i] == ":":
                if text[_skip_space(text, i + 1)] in ",}":
                    i = _skip_space(text, i + 1)
                else:
                    value, i = _flow_node(text, i + 1)
                    i = _skip_space(text, i)
            items[node] = value
        else:
            if text[i] == ":":
                raise ValueError(f"Single-pair map inside a flow list: {text!r}")
            items.append(node)
        if text[i] == ",":
            i = _skip_space(text, i + 1)
        elif text[i] != closer:
            raise ValueError(f"Expected ',' or {closer!r} in {text!r}")
    return items, i + 1


def save_config_to_file(path: Union[str, os.PathLike], config: dict) -> None:
    """Write a config dict as JSON, which every YAML reader also reads, so
    the file is the same whether or not PyYAML is installed."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(_plain(config), indent=2))


def _plain(x: Any) -> Any:
    """Convert numpy / torch scalars and paths to plain Python for dumping."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, os.PathLike):
        return str(x)
    if hasattr(x, "item"):
        try:
            return x.item()
        except Exception:
            pass
    return str(x)


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
