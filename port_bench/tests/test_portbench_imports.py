"""Nothing the harness runs loads JAX or the JAX package; the check
compares whole top-level module names."""

import subprocess
import sys

from port_bench import manifest as mf


def test_foreign_modules_compares_whole_top_level_names():
    assert mf.foreign_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                               "neural_graph_mapping_tpu", "neural_graph_mapping_tpu.ops.permuto"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "neural_graph_mapping_tpu",
        "neural_graph_mapping_tpu.ops.permuto"]
    assert mf.foreign_modules(["neural_graph_mapping_tpu_torch", "neural_graph_mapping_tpu_torch.mapping.engine",
                               "jaxtyping", "flaxen", "port_bench.reference.ngm"]) == []


def test_the_harness_and_the_program_it_drives_load_no_jax():
    code = (
        "import sys, port_bench.run, port_bench.tracing, port_bench.reference.check\n"
        "from port_bench import manifest as mf\n"
        "m = mf.load_manifest()\n"
        "[mf.load_reader(x['name']) for x in m['per_layer']]\n"
        "port_bench.run.program_modules()\n"
        "from neural_graph_mapping_tpu_torch.ops import cuda_build\n"
        "print(mf.foreign_modules(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(mf.ROOT),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, port_bench.reference.check\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('neural_graph_mapping')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(mf.ROOT),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
