"""``python3 -m port_bench --workload NAME --seed N --seconds S --trace 0|1``"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# Build and kernel caches at fixed paths inside the checkout; no library
# the port uses may load JAX by itself.
_CACHE = pathlib.Path(__file__).resolve().parent / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from port_bench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
