"""Wrappers of the hand-written CUDA closest-hit kernels
(csrc/closest_hit.cu), which replace the TPU kernel
rayverb_tpu/ops/intersect_pallas.py::_kernel with the Hit mapping of its
wrapper (intersect_pallas.py:686-690), and the block order that its
wrapper computes (intersect_pallas.py:604-646).

The kernel is built with nvcc at first use (cuda_build) and called through
its C interface with ctypes. This module imports without nvcc or a GPU;
nothing is built until the first launch. The plain versions of the kernels
are intersect.closest_hit_plain (with intersect.hit_from_raw), and
intersect.block_order with its cull, block_keep and cull_order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import ORDER_ENTRIES, PAIR_SUMS

# launches since import (or since the caller last reset them) of the
# sweep kernel and of the block-order kernel; each wrapper adds one per
# launch, and a replayed CUDA graph the launches it holds
# (profiling.add_counts)
launches = 0
order_launches = 0

_fn = None


def _kernel():
    """(rv_closest_hit, rv_block_order) of the built library."""
    global _fn
    if _fn is None:
        from ..cuda_build import load_library

        lib = load_library("closest_hit", ["closest_hit.cu"])
        sweep = lib.rv_closest_hit
        sweep.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ] * 9
        sweep.restype = ctypes.c_int
        order = lib.rv_block_order
        order.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ] * 5
        order.restype = ctypes.c_int
        _fn = (sweep, order)
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


# the block-order kernel (closest_hit_order): groups (one warp each) per
# thread block at most, the shared memory a thread block may use on Hopper
# (227 KB), and the card's SMs, which the thread blocks of a small batch
# should spread over
ORDER_WARPS = 8
ORDER_SMEM_MAX = 227 * 1024
ORDER_SPREAD_SMS = 132


class OrderLaunch(NamedTuple):
    warps: int  # groups per thread block
    smem: int  # dynamic shared memory per thread block, bytes
    spill: bool  # keys in a (groups, nblocks) int64 device-memory scratch


# cached: a vault render's order launches are host-bound, and a cache hit
# costs the host less than the rule
@functools.lru_cache(maxsize=1024)
def order_launch(nblocks: int, groups: int) -> OrderLaunch:
    """The order kernel's launch for a table of ``nblocks`` blocks and
    ``groups`` ray groups. Each warp holds, in shared memory, a key buffer
    of nblocks 64-bit keys and its finite mask (one bit per block, in whole
    8-byte units); where one warp's buffer and mask do not fit, the keys go
    to a device-memory scratch and the warp keeps only its mask. As many
    warps per thread block as fit, at most ORDER_WARPS and at most
    ceil(groups / ORDER_SPREAD_SMS), so that a small batch's thread blocks
    still spread over the SMs. The kernel refuses any other shared-memory
    size (rv_block_order)."""
    words = -(-nblocks // 32)
    mask = 8 * -(-words // 2)
    spill = 8 * nblocks + mask > ORDER_SMEM_MAX
    per_warp = mask + (0 if spill else 8 * nblocks)
    warps = max(1, min(ORDER_WARPS, ORDER_SMEM_MAX // per_warp,
                       -(-groups // ORDER_SPREAD_SMS)))
    return OrderLaunch(warps, warps * per_warp, spill)


def block_order_cuda(origins, dirs, t_max, block_aabb, super_aabb, slices, *,
                     t_decide=None, pair_sums=None):
    """(order, counts) of a sweep in ``slices`` slices, computed by the CUDA
    kernel closest_hit_order in one launch on the current stream: order
    (groups, nblocks) int32 and counts (groups, slices) int32,
    intersect.cull_order of intersect.block_order (each group of
    SWEEP_RAYS rays' near-to-far block order) and of intersect.block_keep
    (the bounds t_max and t_decide, None for +inf and 0). ``super_aabb``
    is intersect.super_aabb of the table (TriangleSoup.super_aabb, checked
    where params.soup_from_numpy builds it). Where pair_sums
    (profiling.pair_sums) is given, the kept entries and groups x nblocks
    are added into pair_sums[ORDER_ENTRIES] and the slot after it. The
    table's block count must be a power of two (build_sweep_table's); the
    tensors contiguous float32 on one CUDA device, the boxes 16-byte
    aligned; t_max None: every ray is live."""
    global order_launches
    if not origins.is_cuda:
        raise ValueError(
            "block_order_cuda needs CUDA tensors; CPU tensors go to "
            "intersect.block_order"
        )
    from .intersect import SWEEP_RAYS

    dev = origins.device
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    _check("origins", origins, (m, 3), torch.float32, dev)
    _check("dirs", dirs, (m, 3), torch.float32, dev)
    if t_max is not None:
        _check("t_max", t_max, (m,), torch.float32, dev)
    if t_decide is not None:
        _check("t_decide", t_decide, (m,), torch.float32, dev)
    _check("block_aabb", block_aabb, (nb, 8), torch.float32, dev)
    if nb <= 0 or nb & (nb - 1):
        raise ValueError(f"block count must be a power of two, got {nb}")
    if not 1 <= slices <= nb:
        raise ValueError(f"slices must lie in [1, {nb}], got {slices}")
    if pair_sums is not None:
        _check("pair_sums", pair_sums, (PAIR_SUMS,), torch.int64, dev)
    aabb_ptr = block_aabb.data_ptr()
    if aabb_ptr % 16:
        raise ValueError("block_aabb must be 16-byte aligned (the kernel reads float4)")
    groups = -(-m // SWEEP_RAYS)
    order = torch.empty((groups, nb), dtype=torch.int32, device=dev)
    counts = torch.empty((groups, slices), dtype=torch.int32, device=dev)
    if m == 0:
        return order, counts
    launch = order_launch(nb, groups)
    spill = (
        torch.empty((groups, nb), dtype=torch.int64, device=dev)
        if launch.spill
        else None
    )
    _, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            origins.data_ptr(),
            dirs.data_ptr(),
            _ptr(t_max),
            _ptr(t_decide),
            aabb_ptr,
            super_aabb.data_ptr(),
            m,
            nb,
            slices,
            launch.warps,
            launch.smem,
            order.data_ptr(),
            counts.data_ptr(),
            None if pair_sums is None else pair_sums.data_ptr() + 8 * ORDER_ENTRIES,
            None if spill is None else spill.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"block order kernel launch failed: CUDA error {err}")
    order_launches += 1
    return order, counts


# (device, stream) -> (keys (n,) int64 all-ones, arrivals (ceil(n / 32),)
# int32 zeros): the sweep's merge scratch for more than one slice, which
# every launch leaves as it found it, so it is filled once and grown when
# a larger batch comes
_merge_scratch: dict = {}


def _ptr(x):
    return None if x is None else x.data_ptr()


def _scratch(dev, stream, m):
    keys, arrivals = _merge_scratch.get((dev, stream), (None, None))
    if keys is None or keys.numel() < m:
        from .intersect import SWEEP_RAYS

        n = max(m, 2 * (0 if keys is None else keys.numel()))
        keys = torch.full((n,), -1, dtype=torch.int64, device=dev)
        arrivals = torch.zeros((-(-n // SWEEP_RAYS),), dtype=torch.int32, device=dev)
        _merge_scratch[(dev, stream)] = (keys, arrivals)
    return keys, arrivals


# row ranges of one sweep that the kernel splits its executed pair tests
# at (csrc/closest_hit.cu kRanges)
KIND_RANGES = 3


def _kind_ranges(kinds, m):
    """The kernel's host array of KIND_RANGES (start, end, kind) triples."""
    if len(kinds) > KIND_RANGES:
        raise ValueError(f"at most {KIND_RANGES} row ranges, got {len(kinds)}")
    flat = []
    for kind, start, end in kinds:
        if not (0 <= kind < 4 and 0 <= start <= end <= m):
            raise ValueError(f"bad row range {(kind, start, end)} of {m} rows")
        flat += [int(start), int(end), int(kind)]
    flat += [0, 0, -1] * (KIND_RANGES - len(kinds))
    return (ctypes.c_int * (3 * KIND_RANGES))(*flat)


def closest_hit_cuda(
    origins, dirs, packed, block_aabb, t_max, t_decide, order, slices, *,
    counts, with_stats=False, pair_sums=None, kinds=(),
):
    """The Hit (intersect.Hit: t (M,) float32, +inf on a miss; index (M,)
    int64, 0 on a miss; hit (M,) bool), and with with_stats=True also the
    (M,) int64 executed pair tests per ray, of the sweep that
    intersect.closest_hit_plain computes with the same arguments and
    schedule, mapped by intersect.hit_from_raw: one launch of the CUDA
    kernel on the current stream, whose epilogue merges the slices and
    writes the Hit. t_max and t_decide may be None (+inf and 0 for every
    ray); counts (groups, slices) int32, the entries each slice walks
    from the start of its run (intersect.cull_order's). Every tensor must be a contiguous CUDA tensor on one device
    (float32; ``order`` and ``counts`` int32); anything else raises.

    pair_sums, a (PAIR_SUMS,) int64 tensor (profiling.pair_sums): the executed
    pair tests of the rows [start, end) of each (kind, start, end) of
    ``kinds`` (at most KIND_RANGES) are added into pair_sums[kind], and the
    rows of the range that enter live (t_max > 0) into pair_sums[4 + kind],
    by the same launch's epilogue; None passes the kernel a null pointer.

    Calls on one device are stream-ordered: every launch goes on the
    current stream (render_fused_sharded runs one process per card), and
    the merge scratch belongs to its (device, stream) pair, so two
    launches that share a scratch never overlap."""
    global launches
    if not origins.is_cuda:
        raise ValueError(
            "closest_hit_cuda needs CUDA tensors; CPU tensors go to "
            "intersect.closest_hit_plain"
        )
    dev = origins.device
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    from .intersect import SWEEP_BLOCK, Hit, check_schedule

    _check("origins", origins, (m, 3), torch.float32, dev)
    _check("dirs", dirs, (m, 3), torch.float32, dev)
    if t_max is not None:
        _check("t_max", t_max, (m,), torch.float32, dev)
    if t_decide is not None:
        _check("t_decide", t_decide, (m,), torch.float32, dev)
    _check("packed", packed, (nb * SWEEP_BLOCK, 16), torch.float32, dev)
    _check("block_aabb", block_aabb, (nb, 8), torch.float32, dev)
    check_schedule(order, slices, m, nb, counts)
    _check("order", order, order.shape, torch.int32, dev)
    _check("counts", counts, counts.shape, torch.int32, dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the kernel reads float4)")
    ranges = None
    if pair_sums is not None:
        _check("pair_sums", pair_sums, (PAIR_SUMS,), torch.int64, dev)
        ranges = _kind_ranges(kinds, m)
    hit = Hit(
        t=torch.empty((m,), dtype=torch.float32, device=dev),
        index=torch.empty((m,), dtype=torch.int64, device=dev),
        hit=torch.empty((m,), dtype=torch.bool, device=dev),
    )
    executed = (
        torch.zeros((m,), dtype=torch.int64, device=dev) if with_stats else None
    )
    if m > 0:
        fn, _ = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            keys, arrivals = _scratch(dev, stream, m) if slices > 1 else (None, None)
            err = fn(
                origins.data_ptr(),
                dirs.data_ptr(),
                _ptr(t_max),
                _ptr(t_decide),
                packed.data_ptr(),
                block_aabb.data_ptr(),
                order.data_ptr(),
                counts.data_ptr(),
                m,
                nb,
                slices,
                _ptr(keys),
                _ptr(arrivals),
                _ptr(executed),
                _ptr(pair_sums),
                ranges,
                hit.t.data_ptr(),
                hit.index.data_ptr(),
                hit.hit.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"closest_hit kernel launch failed: CUDA error {err}")
        launches += 1
    return (hit, executed) if with_stats else hit
