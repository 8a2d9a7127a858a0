"""Wrappers of the hand-written CUDA sort-key kernels (csrc/ray_keys.cu):
each bounce's two sort keys of the trace, the mix6 bounce key and the
shadow rows' direction key, in one launch each, as order-preserving int32
keys (int64 with pair ids).

The kernels replace no TPU kernel: the JAX trace's keys
(rayverb_tpu/ops/trace.py::_ray_sort_key, _shadow_rows) are fused by XLA.
Their plain versions are ops/trace.py::_ray_sort_key and _dir_morton, with
the top bit flipped into int32 (trace._signed32); trace._bounce_key and
trace._shadow_key dispatch between the two.

The library is built with nvcc at first use (cuda_build) and called
through its C interface with ctypes. This module imports without nvcc or a
GPU; nothing is built until the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect_cuda import _check

# launches since import (or since the caller last reset it) of either
# kernel; the wrappers add one per launch, and a replayed CUDA graph the
# launches it holds (profiling.add_counts)
launches = 0

_fn = None


def _kernel():
    """(rv_bounce_key, rv_shadow_key) of the built library."""
    global _fn
    if _fn is None:
        from ..cuda_build import load_library

        lib = load_library("ray_keys", ["ray_keys.cu"])
        bounce = lib.rv_bounce_key
        bounce.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        bounce.restype = ctypes.c_int
        shadow = lib.rv_shadow_key
        shadow.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        shadow.restype = ctypes.c_int
        _fn = (bounce, shadow)
    return _fn


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _launch(fn, name, *args):
    global launches
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches += 1


def bounce_key_cuda(pos, direction, lo, inv_span):
    """(N,) int32: trace._signed32 of trace._ray_sort_key(pos, direction,
    lo, inv_span), bit for bit, in one launch on the current stream. pos
    and direction (N, 3), lo and inv_span (3,): float32 CUDA tensors on one
    device; anything else raises. No host copy and no sync, so the launch
    goes into a CUDA graph being captured."""
    if not pos.is_cuda:
        raise ValueError(
            "bounce_key_cuda needs CUDA tensors; CPU tensors go to "
            "trace._ray_sort_key"
        )
    dev = pos.device
    n = pos.shape[0]
    pos, direction = pos.contiguous(), direction.contiguous()
    lo, inv_span = lo.contiguous(), inv_span.contiguous()
    _check("pos", pos, (n, 3), torch.float32, dev)
    _check("direction", direction, (n, 3), torch.float32, dev)
    _check("lo", lo, (3,), torch.float32, dev)
    _check("inv_span", inv_span, (3,), torch.float32, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            _launch(_kernel()[0], "bounce key", pos.data_ptr(), direction.data_ptr(),
                    lo.data_ptr(), inv_span.data_ptr(), n, out.data_ptr())
    return out


def shadow_key_cuda(d, alive, pair=None):
    """The shadow rows' sort key of trace._shadow_key, bit for bit, in one
    launch on the current stream: without ``pair``, (N,) int32,
    trace._signed32 of where(alive, trace._dir_morton(d), 0xFFFFFFFF); with
    it, (N,) int64, (where(alive, pair, 0x7FFFFFFF) << 32) | that uint32
    key. d (N, 3) float32, alive (N,) bool, pair (N,) int64 (values below
    2**31): CUDA tensors on one device; anything else raises. No host copy
    and no sync."""
    if not d.is_cuda:
        raise ValueError(
            "shadow_key_cuda needs CUDA tensors; CPU tensors go to "
            "trace._dir_morton"
        )
    dev = d.device
    n = d.shape[0]
    d, alive = d.contiguous(), alive.contiguous()
    _check("d", d, (n, 3), torch.float32, dev)
    _check("alive", alive, (n,), torch.bool, dev)
    if pair is not None:
        pair = pair.contiguous()
        _check("pair", pair, (n,), torch.int64, dev)
    out = torch.empty((n,), dtype=torch.int32 if pair is None else torch.int64,
                      device=dev)
    if n:
        with torch.cuda.device(dev):
            _launch(_kernel()[1], "shadow key", d.data_ptr(), alive.data_ptr(),
                    None if pair is None else pair.data_ptr(), n, out.data_ptr())
    return out
