"""Build the port's CUDA sources with nvcc into C-interface shared
libraries, loaded with ctypes.

Each library is built from the ``.cu`` files under ``csrc/`` at first use,
into ``_build/`` beside this file (listed in .gitignore), and keyed by the
SHA-256 of its sources and flags, so a changed source builds anew and an
unchanged one is reused. No PyTorch headers are compiled: the sources expose
``extern "C"`` functions that take raw device pointers and a stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_TIMEOUT_S = 180

# Hopper only; no FMA contraction and IEEE division, so kernels reproduce
# their plain PyTorch versions bit for bit.
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
    "-shared",
)

# one lock per library, so that libraries build in parallel threads (one
# nvcc each) while a second caller of the same library waits for its build
_locks_guard = threading.Lock()
_locks: dict = {}
_libs: dict = {}
# name -> {"seconds": build wall (0.0 when reused), "log": nvcc's output,
#          "path": the loaded library}
build_info: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _key(sources) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load ``_build/<name>-<hash>.so`` from the given
    ``.cu`` file names under csrc/. Raises RuntimeError when nvcc fails or
    runs past NVCC_TIMEOUT_S. Libraries of other names may build at the
    same time, each in its own thread."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        paths = [os.path.join(CSRC, s) for s in sources]
        out = os.path.join(BUILD_DIR, f"{name}-{_key(paths)}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *paths]
            try:
                proc = subprocess.run(
                    cmd, capture_output=True, text=True,
                    timeout=NVCC_TIMEOUT_S,
                )
            except subprocess.TimeoutExpired as e:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc ran past {NVCC_TIMEOUT_S} s building {name}"
                ) from e
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed building {name}:\n{log}")
            os.replace(tmp, out)  # atomic: no half-written library is seen
        lib = ctypes.CDLL(out)
        build_info[name] = {
            "seconds": time.perf_counter() - t0, "log": log, "path": out,
        }
        _libs[name] = lib
        return lib
