"""The block order's edge cases and sort keys, shared by the CPU tests
(tests/test_torch_order.py) and chip_smoke.py: each case is a batch on
which the order kernel (intersect_cuda.block_order_cuda) must equal its
plain version (intersect.cull_order of intersect.block_order and
intersect.block_keep) bit for bit.

The keys are block_order's own (rank bits * nblocks + block index); those
below 0x7F800000 * nblocks are the k blocks of finite rank that the kernel
sorts (csrc/closest_hit.cu, closest_hit_order)."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSILON
from .intersect import SWEEP_RAYS, _slab


def order_cases(nblocks, seed=0):
    """Edge cases of the block order (intersect.block_order and its
    kernel) on a table of ``nblocks`` AABBs: a list of (name, origins,
    dirs, t_max, aabb), float32 numpy arrays of 70 rays (3 groups, the last
    ragged). Group 1's first 5 rays and all of group 2 are dead (t_max 0),
    so group 1's representative is its 6th ray and group 2's its first. k
    (the blocks of finite rank, which the kernel sorts) is 0 in
    ``k0_missed``, nblocks in ``k_all_inside`` (every AABB holds the
    origin: all ranks tie at 0) and k in ``k<k>`` for 31, 32 and 33 where
    nblocks allows; the other cases mix ties at rank 0, axis-parallel and
    tiny (|d| < 1e-30) directions, ranks that overflow to +inf on a met
    block, and random rays and boxes."""
    rng = np.random.default_rng(seed)
    m, nb = 70, nblocks
    t_max = np.full(m, np.inf, np.float32)
    t_max[32:37] = 0.0
    t_max[64:] = 0.0
    origin = np.zeros((m, 3), np.float32)
    along_x = np.tile(np.float32([1, 0, 0]), (m, 1))

    def boxes(lo, size):
        b = np.zeros((nb, 8), np.float32)
        b[:, 0:3] = lo
        b[:, 3:6] = np.asarray(lo, np.float32) + np.asarray(size, np.float32)
        return b

    def on_line(x):
        """lower corners at x whose y and z ranges hold 0 (sizes >= 2)"""
        return np.stack([x, -rng.uniform(0.1, 1.9, nb), -rng.uniform(0.1, 1.9, nb)], 1)

    size = rng.uniform(2.0, 4.0, (nb, 3))
    ahead = on_line(rng.integers(1, 40, nb).astype(np.float64))  # rank ties too
    missed = ahead + [0.0, 10.0, 0.0]  # y range above the line
    cases = [("k0_missed", origin, along_x, t_max,
              boxes(on_line(-rng.uniform(10, 100, nb)), size))]
    inside = -rng.uniform(0.1, 5, (nb, 3))
    cases.append(("k_all_inside", origin, along_x, t_max,
                  boxes(inside, rng.uniform(5.1, 10, (nb, 3)))))
    pick = rng.random(nb)
    lo = np.where((pick < 0.5)[:, None], inside, np.where((pick < 0.75)[:, None], ahead, missed))
    sz = np.where((pick < 0.5)[:, None], 10.0, size)
    cases.append(("ties_at_zero", origin, along_x, t_max, boxes(lo, sz)))
    for k in (31, 32, 33):
        if k <= nb:
            met = np.zeros(nb, bool)
            met[rng.choice(nb, k, replace=False)] = True
            cases.append((f"k{k}", origin, along_x, t_max,
                          boxes(np.where(met[:, None], ahead, missed), size)))
    # axis-parallel (+-0.0) and tiny components, one direction per group
    tiny = np.zeros((m, 3), np.float32)
    tiny[:32] = [1.0, 1e-31, -0.0]
    tiny[32:64] = [1e-40, 1.0, 0.0]
    tiny[64:] = [0.0, -0.0, -1.0]
    cases.append(("tiny_directions", origin, tiny, t_max,
                  boxes(rng.uniform(-20, 20, (nb, 3)), rng.uniform(0.5, 25, (nb, 3)))))
    # rank x * 1e20: x in [1e19, 1e20] overflows to +inf on a met block
    slow = np.tile(np.float32([1e-20, 0, 0]), (m, 1))
    far = on_line(rng.uniform(1e19, 1e20, nb))
    lo = np.where((pick < 0.33)[:, None], far, np.where((pick < 0.66)[:, None], ahead, missed))
    cases.append(("overflow_to_inf", origin, slow, t_max,
                  boxes(lo, np.where((pick < 0.33)[:, None], 1e19, size))))
    o = rng.uniform(-20, 20, (m, 3))
    d = rng.standard_normal((m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = rng.random(m)
    tm = np.select([u < 0.6, u < 0.8, u < 0.9], [np.inf, rng.uniform(1, 50, m), 0.0], -1.0)
    cases.append(("random", o, d, tm,
                  boxes(rng.uniform(-30, 30, (nb, 3)), rng.uniform(0.5, 12, (nb, 3)))))
    return [(name, *(np.ascontiguousarray(x, np.float32) for x in arrays))
            for name, *arrays in cases]


def order_keys(origins, dirs, t_max, block_aabb):
    """(groups, nblocks) int64 sort keys of intersect.block_order (rank
    bits * nblocks + block index), computed as it computes them: argsort
    of a row is the group's order row, and the keys below 0x7F800000 *
    nblocks are the k blocks of finite rank that the order kernel sorts."""
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    groups = -(-m // SWEEP_RAYS)
    dev = origins.device
    live = torch.zeros((groups * SWEEP_RAYS,), dtype=torch.uint8, device=dev)
    live[:m] = t_max > 0
    first = torch.argmax(live.view(groups, SWEEP_RAYS), dim=1)
    rep = torch.clamp(torch.arange(groups, device=dev) * SWEEP_RAYS + first, max=max(m - 1, 0))
    o = origins[rep][:, None, :]
    d = dirs[rep][:, None, :]
    tn, tf = _slab(o, d, 1.0 / d, block_aabb)
    rank = torch.where(tf >= torch.clamp(tn, min=EPSILON), torch.clamp(tn, min=0.0), float("inf"))
    bits = rank.view(torch.int32) & 0x7FFFFFFF
    return bits.to(torch.int64) * nb + torch.arange(nb, device=dev)


def order_k(keys):
    """(groups,) blocks of finite rank per group, from order_keys."""
    return (keys < 0x7F800000 * keys.shape[1]).sum(dim=1)
