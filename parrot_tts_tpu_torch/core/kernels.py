"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library under `build/kernels/` at the root of the checkout (git ignores
it), named by a hash of the source so an edited kernel is rebuilt. Nothing
is built when a module is imported: a wrapper calls `load(name)` at its
first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    # torch's CUDA_HOME: $CUDA_HOME, else nvcc on PATH, else /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless it is already built; returns nvcc's
    output (the ptxas register and shared-memory report), "" when there
    was nothing to build. Raises on failure."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, target)      # atomic: readers never see a partial file
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it on first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
