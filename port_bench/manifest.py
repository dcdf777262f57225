"""The benchmark's manifest (``BENCHMARK.json``) and the files it names:
configurations in ``configs/``, traffic mixes in ``workloads/`` and
per-layer metric readers in ``metrics/``, each found by its name."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_MODULES = ("jax", "jaxlib", "flax", "neural_graph_mapping_tpu")


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_workload(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def load_reader(name: str) -> ModuleType:
    """The per-layer metric ``name``'s reader module, from its own file."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def cell_entry(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def foreign_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, its libraries' or
    the JAX package's (the port's name only begins with the latter's)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in JAX_MODULES)
