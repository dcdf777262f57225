"""The PyTorch port stands alone: importing every module of it (and
chip_smoke.py, which drives it on the card) loads neither ``jax`` nor the
JAX package."""

import os
import subprocess
import sys

import numpy as np

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
    assert n_modules >= 57  # every module of the port was imported


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
    "neural_graph_mapping_tpu_torch.datasets.replica",
    "neural_graph_mapping_tpu_torch.datasets.scannet",
    "neural_graph_mapping_tpu_torch.datasets.kintinuous",
    "neural_graph_mapping_tpu_torch.utils.imageio",
    "neural_graph_mapping_tpu_torch.scripts.check_dataset",
    "neural_graph_mapping_tpu_torch.examples.fit_synthetic",
    "neural_graph_mapping_tpu_torch.vis.simplify_mesh",
    "neural_graph_mapping_tpu_torch.vis.vis_mesh",
    "neural_graph_mapping_tpu_torch.vis.vis_dataset",
    "neural_graph_mapping_tpu_torch.vis.vis_checkpoint",
    "neural_graph_mapping_tpu_torch.parallel",
    "neural_graph_mapping_tpu_torch.parallel.sharding",
    "neural_graph_mapping_tpu_torch.utils.jpeg",
    "neural_graph_mapping_tpu_torch.scripts.score_checkpoint",
]

_BLOCKER = """
import importlib, pkgutil, sys

BLOCKED = ("yaml", "PIL", "tabulate", "matplotlib", "jax", "neural_graph_mapping_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocker())
"""

_BLOCKED_PROBE = _BLOCKER + """
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


_READ_PROBE = _BLOCKER + """
import numpy as np
from neural_graph_mapping_tpu_torch.datasets.nrgbd import NRGBDDataset
from neural_graph_mapping_tpu_torch.datasets.replica import ReplicaDataset
from neural_graph_mapping_tpu_torch.scripts import check_dataset

root = sys.argv[1]
cam = dict(width=16, height=12, fx=10.0, fy=10.0, cx=8.0, cy=6.0)
nrgbd = NRGBDDataset(dict(root_dir=root + "/nrgbd", scene="whiteroom", camera=cam))
replica = ReplicaDataset(dict(root_dir=root + "/replica", scene="office0"))
np.save(root + "/nrgbd.npy", nrgbd[1]["rgbd"])
np.save(root + "/replica.npy", replica[1]["rgbd"])
sys.exit(check_dataset.main(["replica", root + "/replica", "office0"]))
"""


def test_png_frames_read_without_the_packages_the_card_lacks(tmp_path):
    """With PIL, PyYAML and JAX blocked, the port's NRGBD and Replica loaders
    read a PNG fixture frame (through ``utils/imageio``) to the values the
    JAX package's loaders read with PIL, and check_dataset passes."""
    from test_torch_datasets import write_nrgbd, write_replica

    from neural_graph_mapping_tpu.datasets.nrgbd import NRGBDDataset as JaxNRGBD
    from neural_graph_mapping_tpu.datasets.replica import ReplicaDataset as JaxReplica

    cfg = write_nrgbd(tmp_path / "nrgbd")
    rcfg = write_replica(tmp_path / "replica", ext="png")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _READ_PROBE, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "nrgbd.npy"), JaxNRGBD(cfg)[1]["rgbd"])
    np.testing.assert_array_equal(np.load(tmp_path / "replica.npy"), JaxReplica(rcfg)[1]["rgbd"])
