"""Build the hand-written CUDA kernels under `vod_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with `nvcc`
into its own shared library for `sm_90a` (Hopper), loaded with `ctypes`. No
source includes PyTorch's headers: that keeps a build to seconds. Libraries go
to `vod_tpu_torch/_build/`, keyed by a hash of the source and the flags, and
are built at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()  # guards the two dicts
_build_locks: dict[str, threading.Lock] = {}  # one per source: builds of two sources overlap
libraries: dict[str, ctypes.CDLL] = {}  # loaded kernels, by source name


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's standard location
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(name: str) -> tuple[Path, float, str]:
    """Compile `csrc/<name>.cu` unless its library is built already. Returns
    (library path, nvcc seconds or 0.0, nvcc's output with registers, shared
    memory and spills per kernel). Raises with the compiler's output on failure.
    Threads may build different sources at once."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        if out.exists():
            return out, 0.0, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent process sees a whole library or none
        return out, seconds, proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = libraries.get(name)
    if lib is None:
        path, _, _ = build(name)
        with _lock:
            lib = libraries.setdefault(name, ctypes.CDLL(str(path)))
    return lib
