"""Build, load and launch the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for sm_90a into a shared library with a
plain C interface under ``_build/`` (named by a hash of the source and the
flags, so an edited source builds anew) and loaded with ctypes. Sources that
are not built yet are compiled together: one ``nvcc`` process each, all
started at once. Nothing is built at import time; the first call that needs
a library builds it. The launch helpers below are shared by the kernel
wrappers (``ops/permuto_cuda.py``, ``ops/topk.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict

import torch

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES: Dict[str, pathlib.Path] = {
    "permuto": CSRC / "permuto.cu",
    "topk": CSRC / "topk.cu",
}
# -fmad=false: every multiply and add rounds on its own, exactly as the plain
# PyTorch versions (one elementwise kernel per operation) round them, so
# lattice corners and top-2 distances agree bit for bit with them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Library:
    """A loaded shared library, its build time and the compiler's report."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, build_log: str) -> None:
        self.lib = lib
        self.build_seconds = build_seconds
        self.build_log = build_log


_LOADED: Dict[str, Library] = {}


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> pathlib.Path:
    src = SOURCES[name].read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libngm_{name}_{tag}.so"


def load(*names: str) -> Dict[str, Library]:
    """Build what is missing of the named sources (all ``nvcc`` runs in
    parallel), load them, and return {name: Library}."""
    for name in names:
        if name not in SOURCES:
            raise KeyError(f"unknown CUDA source {name!r}; known: {sorted(SOURCES)}")
    todo = [n for n in names if n not in _LOADED]
    if todo:
        t0 = time.perf_counter()
        running = {}
        for name in todo:
            out = _target(name)
            if out.is_file():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in running.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        if failed:
            raise RuntimeError("\n".join(failed))
        seconds = time.perf_counter() - t0
        for name in todo:
            _LOADED[name] = Library(ctypes.CDLL(str(_target(name))), seconds, logs.get(name, ""))
    return {n: _LOADED[n] for n in names}


def load_all() -> Dict[str, Library]:
    """Build and load every source of the port."""
    return load(*SOURCES)


def route(*tensors: torch.Tensor) -> str:
    """'cuda' or 'cpu' for tensors that all lie on one such device; raise else.
    A wrapper takes its plain version only for 'cpu'."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        if dev.index is not None and dev.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {dev}, current device is {torch.cuda.current_device()}")
        return "cuda"
    if dev.type == "cpu":
        return "cpu"
    raise ValueError(f"unsupported device {dev}")


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
