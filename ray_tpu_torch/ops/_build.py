"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``ops/build/`` at its
first use and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds rather than minutes). The library's file name carries a
hash of its source and of every shared header ``csrc/*.cuh``, so an
edited kernel or header never loads a stale build. ``build_all`` starts
one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def sources() -> List[str]:
    """The names of every kernel library: one per ``csrc/<name>.cu``."""
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path(name)
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0, "log": "(cached)"}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}


def build_all() -> Dict[str, dict]:
    """``build`` every kernel library, one ``nvcc`` per source, all started
    together. Raises the first failure after every build has ended."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _libs[name] = lib
    return lib
