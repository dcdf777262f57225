"""The PyTorch port stands alone: importing every module of it (and
chip_smoke.py, which drives it on the card) loads neither ``jax`` nor the
JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import neural_graph_mapping_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "neural_graph_mapping_tpu" or m.startswith("neural_graph_mapping_tpu."))
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 40  # every module of the port was imported


NEW_MODULES = [
    "neural_graph_mapping_tpu_torch.run_mapping",
    "neural_graph_mapping_tpu_torch.ops.native",
    "neural_graph_mapping_tpu_torch.mapping.meshing",
    "neural_graph_mapping_tpu_torch.eval.culling",
    "neural_graph_mapping_tpu_torch.eval.mesh_metrics",
    "neural_graph_mapping_tpu_torch.utils.meshio",
    "neural_graph_mapping_tpu_torch.utils.profiling",
    "neural_graph_mapping_tpu_torch.utils.prefetch",
    "neural_graph_mapping_tpu_torch.utils.observability",
    "neural_graph_mapping_tpu_torch.datasets.nrgbd",
]

_BLOCKED_PROBE = """
import importlib, pkgutil, sys

BLOCKED = ("yaml", "PIL", "tabulate", "matplotlib", "jax", "neural_graph_mapping_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocker())
import neural_graph_mapping_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
"""


def test_port_imports_without_the_packages_the_card_lacks():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split())
    assert set(NEW_MODULES) <= imported, set(NEW_MODULES) - imported
