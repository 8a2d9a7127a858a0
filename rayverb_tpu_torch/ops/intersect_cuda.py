"""Wrapper of the hand-written CUDA closest-hit kernel
(csrc/closest_hit.cu), which replaces the TPU kernel
rayverb_tpu/ops/intersect_pallas.py::_kernel.

The kernel is built with nvcc at first use (cuda_build) and called through
its C interface with ctypes. This module imports without nvcc or a GPU;
nothing is built until the first launch. The plain version of the kernel is
intersect.closest_hit_plain.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since the caller last reset it); the
# wrapper adds one per launch and nowhere else
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ..cuda_build import load_library

        lib = load_library("closest_hit", ["closest_hit.cu"])
        fn = lib.rv_closest_hit
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p
        ] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _check(name, x, shape, dtype, device):
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def closest_hit_cuda(origins, dirs, packed, block_aabb, t_max, t_decide):
    """Raw (best_t (M,) float32, best_i (M,) int32, -1 = none): the same
    contract and arguments as intersect.closest_hit_plain, computed by the
    CUDA kernel on the current stream. Every tensor must be a contiguous
    float32 CUDA tensor on one device; anything else raises."""
    global launches
    if not origins.is_cuda:
        raise ValueError(
            "closest_hit_cuda needs CUDA tensors; CPU tensors go to "
            "intersect.closest_hit_plain"
        )
    dev = origins.device
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    from .intersect import SWEEP_BLOCK

    _check("origins", origins, (m, 3), torch.float32, dev)
    _check("dirs", dirs, (m, 3), torch.float32, dev)
    _check("t_max", t_max, (m,), torch.float32, dev)
    _check("t_decide", t_decide, (m,), torch.float32, dev)
    _check("packed", packed, (nb * SWEEP_BLOCK, 16), torch.float32, dev)
    _check("block_aabb", block_aabb, (nb, 8), torch.float32, dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the kernel reads float4)")
    best_t = torch.empty((m,), dtype=torch.float32, device=dev)
    best_i = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return best_t, best_i
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            origins.data_ptr(),
            dirs.data_ptr(),
            t_max.data_ptr(),
            t_decide.data_ptr(),
            packed.data_ptr(),
            block_aabb.data_ptr(),
            m,
            nb,
            best_t.data_ptr(),
            best_i.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"closest_hit kernel launch failed: CUDA error {err}")
    launches += 1
    return best_t, best_i
