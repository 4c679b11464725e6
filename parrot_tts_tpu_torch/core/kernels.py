"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library under `build/kernels/` at the root of the checkout (git ignores
it), named by a hash of the source and of every header it includes from
`csrc/` (`#include "name.cuh"`, followed through the headers' own
includes), so an edited kernel or header is rebuilt. Nothing is built
when a module is imported: a wrapper calls `load(name)` at its
first launch, and `build(*names)` compiles several sources in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and every csrc header it includes, directly or
    through another header, each once, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode() for inc in
                 _INCLUDE.findall(path.read_bytes())
                 if (path.parent / inc.decode()).exists()]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile each csrc/<name>.cu that is not built yet, one nvcc per
    source, all started together. Returns each name's nvcc output (the
    ptxas register and shared-memory report; "" when there was nothing to
    build). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in dict.fromkeys(names):
        if library_path(name).exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, library_path(name))  # atomic: no partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it on first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
