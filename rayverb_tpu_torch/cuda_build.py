"""Build the port's native sources into C-interface shared libraries,
loaded with ctypes: the CUDA kernels with nvcc, the OBJ parser with g++.

Each library is built from its sources at first use (the ``.cu`` files
under ``csrc/``; ``native/objparse.cpp``), into ``_build/`` beside this
file (listed in .gitignore), and keyed by the SHA-256 of its sources and
compile command, so a changed source builds anew and an unchanged one is
reused. No PyTorch headers are compiled: the sources expose ``extern "C"``
functions (the kernels' take raw device pointers and a stream).
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

from .utils import profiling

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_TIMEOUT_S = 180
GXX_TIMEOUT_S = 120

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

GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

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


def _key(sources, command) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(command).encode())
    return h.hexdigest()[:16]


def load_library(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) with nvcc and load ``_build/<name>-<hash>.so`` from
    the given ``.cu`` file names under csrc/. Raises RuntimeError when nvcc
    fails or runs past NVCC_TIMEOUT_S. Libraries of other names may build
    at the same time, each in its own thread."""
    return _load(name, [os.path.join(CSRC, s) for s in sources],
                 [nvcc_path(), *NVCC_FLAGS], NVCC_TIMEOUT_S)


def load_host_library(name: str, paths) -> ctypes.CDLL:
    """As load_library, for C++ host sources (full paths) built with g++
    under GXX_TIMEOUT_S."""
    return _load(name, list(paths), ["g++", *GXX_FLAGS], GXX_TIMEOUT_S)


def _load(name: str, paths, command, timeout: int) -> ctypes.CDLL:
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        # a one-time span, named in the first call's tree and the process's
        # store (utils.profiling)
        with profiling.once("rv.load_library", name=name) as span:
            _libs[name], built = _build_and_load(name, paths, command, timeout)
            span.set(built=built)
        return _libs[name]


def _build_and_load(name: str, paths, command, timeout: int):
    """Build the library unless its keyed file is there, and load it:
    (the library, whether it was built)."""
    out = os.path.join(BUILD_DIR, f"{name}-{_key(paths, command[1:])}.so")
    t0 = time.perf_counter()
    log = ""
    built = not os.path.isfile(out)
    if built:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*command, "-o", tmp, *paths]
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise RuntimeError(f"{command[0]} failed building {name}: {e}") from e
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{command[0]} failed building {name}:\n{log}")
        os.replace(tmp, out)  # atomic: no half-written library is seen
    lib = ctypes.CDLL(out)
    build_info[name] = {
        "seconds": time.perf_counter() - t0, "log": log, "path": out,
    }
    return lib, built
