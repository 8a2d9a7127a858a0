"""Closest-hit ray/triangle queries: the scene table, the plain sweep and
the dispatcher (PyTorch counterpart of rayverb_tpu/ops/intersect.py).

Every geometric question of the trace (direct path, bounce hits, mic shadow
rays, image-source segment validation, image mic visibility) is one batched
closest-hit sweep over the scene's packed Woop rows. The sweep has two
implementations with one contract:

  - ``closest_hit_plain``: chunked brute-force PyTorch over the packed rows,
    the kernel's plain version (CPU tensors, tests, on-card comparisons)
  - ``intersect_cuda.closest_hit_cuda``: the hand-written CUDA kernel
    (csrc/closest_hit.cu), taken for every CUDA tensor; its epilogue
    merges the slices and writes the Hit (``hit_from_raw`` is its plain
    version)

Contract (that of rayverb_tpu/ops/intersect_pallas.py::_kernel):
  - pair test on the Woop rows of ``build_sweep_table``: ``|n.d| < EPSILON``
    is degenerate, strict barycentric bounds, ``t > EPSILON``
  - ``best_t`` starts at the per-ray ``t_max`` (inclusive); ``best_i`` at -1
  - equal ``t`` resolves to the lowest ORIGINAL triangle index
  - a ray stops refining once ``best_t < t_decide`` (any-hit verdict rows)
  - per ray and per triangle block, an AABB slab test against the running
    ``best_t`` skips blocks that cannot improve the ray (conservative)

Both implementations follow one schedule, computed once per sweep by
``sweep_schedule``: each group of SWEEP_RAYS rays walks the blocks in its
own near-to-far order (``block_order``), cut into S contiguous slices
(``sweep_slices``) that run independently, each with its own running best;
the slices' results merge by the minimum of a 64-bit key (``pack_keys``).
Each slice walks only the blocks that some ray of its group can need at
its bound (``block_keep``), put first in its run (``cull_order``): the
others would fail every ray's entry test, so the cull changes no result
and no executed-pair count.
Closest-hit rows (``t_decide = 0``) do not depend on the schedule; decided
rows may return another witness blocker, never another verdict. Per ray,
slice and block both decide at the block's entry whether it runs, and their
arithmetic is the same operation for operation, so on the same inputs and
schedule the kernel's Hit is bit for bit ``hit_from_raw`` of the plain
version's results, with the same executed-pair counts (the kernel is built
without FMA contraction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import EPSILON
from ..device import resolve_device
from ..utils import profiling
from ..utils.directions import _morton3

# Triangle rows per sweep block and per block AABB (the JAX package's
# default RAYVERB_SWEEP_BLOCK). The CUDA kernel stages one block per step.
SWEEP_BLOCK = 128

# Rays per group of the block order; one CUDA thread block (4 threads per
# ray) sweeps one group against one table slice.
SWEEP_RAYS = 32

# Table slices of a sweep (sweep_slices), set from whole renders' sweeps
# timed on the H100 at 1-16 slices (rayverb_tpu_torch.sweep_scan; PERF.md,
# Findings): closest-hit batches ran fastest at about 8 slices at every
# ray count and scene measured; for decided batches (any-hit rows) each
# slice decides on its own best, and more slices cost more executed pairs
# than they save, unless the groups alone leave most of the card idle.
CLOSEST_SLICES = 8
DECIDED_TARGET_CTAS = 132 * 4

# blocks per superblock: the order kernel culls a group's blocks by their
# superblock's box first (csrc/closest_hit.cu kSuperBlocks)
SUPER_BLOCKS = 32

# rays per plain-sweep chunk (PLAIN_RAY_CHUNK / SWEEP_RAYS groups, each
# with one gathered block): bounds the (rays, SWEEP_BLOCK) planes.
PLAIN_RAY_CHUNK = 1 << 15

# (ray, block) tests per chunk of the plain cull (block_keep)
PLAIN_CULL_CHUNK = 1 << 22

_BIG_I32 = 0x7FFFFFFF


class TriangleSoup(NamedTuple):
    """Scene geometry as tensors on one device (fields as in
    rayverb_tpu/ops/intersect.py:31-72)."""

    v0: torch.Tensor          # (T, 3)
    e0: torch.Tensor          # (T, 3) = v1 - v0
    e1: torch.Tensor          # (T, 3) = v2 - v0
    normal: torch.Tensor      # (T, 3) unit face normal
    surface: torch.Tensor     # (T,) int64 row into specular/diffuse
    specular: torch.Tensor    # (S, 8)
    diffuse: torch.Tensor     # (S, 8)
    packed: torch.Tensor      # (Tp, 16) Morton-sorted Woop rows
    block_aabb: torch.Tensor  # (Tp/SWEEP_BLOCK, 8) per-block [lo, hi, 0, 0]
    bounds: torch.Tensor      # (2, 3) scene AABB
    super_aabb: torch.Tensor  # (superblocks, 8) super_aabb(block_aabb)

    @property
    def num_padded(self) -> int:
        return int(self.packed.shape[0])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def verts(self, idx: torch.Tensor) -> torch.Tensor:
        """Gather (..., 3, 3) triangle vertices for triangle indices."""
        v0 = self.v0[idx]
        return torch.stack([v0, v0 + self.e0[idx], v0 + self.e1[idx]], dim=-2)


def build_sweep_table(v0, e0, e1, block: int = SWEEP_BLOCK):
    """Host-side sweep table: Morton order + packed Woop rows + per-block
    AABBs, byte-equal to rayverb_tpu/ops/intersect.py:94-189. Returns
    (packed (Tp, 16), aabbs (Tp/block, 8)) numpy float32.

    Row layout: cols 0:3 row_u = (e1 x n)/|n|^2, 3:6 row_v = (n x e0)/|n|^2,
    6:9 n = e0 x e1, 9 original index, 10 bu = -row_u.v0, 11 bv = -row_v.v0,
    12 bw = -n.v0. A pair test is then t = -(n.o + bw)/(n.d),
    u = row_u.(o + t d) + bu, v likewise; n.d is minus the Moller-Trumbore
    determinant. The transforms are computed in float64 and rounded once.
    """
    v0 = np.asarray(v0, np.float32)
    e0 = np.asarray(e0, np.float32)
    e1 = np.asarray(e1, np.float32)
    t = v0.shape[0]
    if t >= (1 << 24):
        raise ValueError("sweep table supports < 2^24 triangles")

    centroid = v0 + (e0 + e1) / 3.0
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip(((centroid - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable").astype(np.int64)

    # block count: at least 8, rounded up to a power of two (the JAX
    # package's table shape, kept so that both tables are byte-equal)
    nb = max(8, -(-t // block))
    nb = 1 << (nb - 1).bit_length()
    tp = nb * block

    a64 = v0[order].astype(np.float64)
    e064 = e0[order].astype(np.float64)
    e164 = e1[order].astype(np.float64)
    nvec = np.cross(e064, e164)
    den = np.einsum("ij,ij->i", nvec, nvec)
    safe = np.where(den > 0, den, 1.0)[:, None]
    row_u = np.where(den[:, None] > 0, np.cross(e164, nvec) / safe, 0.0)
    row_v = np.where(den[:, None] > 0, np.cross(nvec, e064) / safe, 0.0)

    packed = np.zeros((tp, 16), np.float32)
    packed[:t, 0:3] = row_u.astype(np.float32)
    packed[:t, 3:6] = row_v.astype(np.float32)
    packed[:t, 6:9] = nvec.astype(np.float32)
    packed[:t, 9] = order.astype(np.float32)
    packed[:t, 10] = -np.einsum("ij,ij->i", row_u, a64).astype(np.float32)
    packed[:t, 11] = -np.einsum("ij,ij->i", row_v, a64).astype(np.float32)
    packed[:t, 12] = -np.einsum("ij,ij->i", nvec, a64).astype(np.float32)

    # conservative per-block AABB over all three vertices; padding rows are
    # excluded; fully-empty blocks get a far-away point AABB no ray reaches
    p0 = np.zeros((tp, 3), np.float32)
    p1 = np.zeros((tp, 3), np.float32)
    p2 = np.zeros((tp, 3), np.float32)
    p0[:t] = v0[order]
    p1[:t] = v0[order] + e0[order]
    p2[:t] = v0[order] + e1[order]
    allp = np.stack([p0, p1, p2], axis=1)  # (Tp, 3, 3)
    real = np.zeros((tp,), bool)
    real[:t] = True
    big = np.float32(1e30)
    lo_rows = np.where(real[:, None, None], allp, big).reshape(
        tp // block, block * 3, 3
    )
    hi_rows = np.where(real[:, None, None], allp, -big).reshape(
        tp // block, block * 3, 3
    )
    pad = np.float32(1e-4)
    aabbs = np.zeros((tp // block, 8), np.float32)
    aabbs[:, 0:3] = lo_rows.min(axis=1) - pad
    aabbs[:, 3:6] = hi_rows.max(axis=1) + pad
    empty = ~real.reshape(tp // block, block).any(axis=1)
    aabbs[empty, 0:3] = big
    aabbs[empty, 3:6] = big
    return packed, aabbs


def super_aabb(block_aabb):
    """(superblocks, 8) boxes of SUPER_BLOCKS consecutive blocks each (all
    the blocks where there are fewer): [min of their lo, max of their hi,
    0, 0], so that each holds its blocks' boxes, the empty blocks' far
    point included. Host numpy float32, built with the sweep table."""
    aabb = np.asarray(block_aabb, np.float32)
    nb = aabb.shape[0]
    per = min(nb, SUPER_BLOCKS)
    if nb % per:
        raise ValueError(f"{nb} blocks do not make superblocks of {per}")
    boxes = aabb.reshape(nb // per, per, 8)
    out = np.zeros((nb // per, 8), np.float32)
    out[:, 0:3] = boxes[:, :, 0:3].min(axis=1)
    out[:, 3:6] = boxes[:, :, 3:6].max(axis=1)
    return out


def scene_fields(v0, e0, e1, surface, specular, diffuse) -> dict:
    """Host numpy fields of a soup (normals, sweep table, bounds) from
    triangle arrays: the state that ``params.soup_from_numpy`` uploads."""
    v0 = np.asarray(v0, np.float32)
    e0 = np.asarray(e0, np.float32)
    e1 = np.asarray(e1, np.float32)
    n = np.cross(e0, e1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.where(norm == 0, 1, norm), 0.0)
    packed, aabbs = build_sweep_table(v0, e0, e1)
    p_all = np.concatenate([v0, v0 + e0, v0 + e1], axis=0)
    bounds = np.stack([p_all.min(axis=0), p_all.max(axis=0)])
    return dict(
        v0=v0,
        e0=e0,
        e1=e1,
        normal=n.astype(np.float32),
        surface=np.asarray(surface, np.int32),
        specular=np.asarray(specular, np.float32),
        diffuse=np.asarray(diffuse, np.float32),
        packed=packed,
        block_aabb=aabbs,
        bounds=bounds.astype(np.float32),
    )


def soup_from_arrays(v0, e0, e1, surface, specular, diffuse,
                     device=None) -> TriangleSoup:
    """Build a TriangleSoup (the sweep table included) on ``device`` (None:
    the card) from host triangle arrays (rayverb_tpu/ops/intersect.py:192)."""
    from ..params import soup_from_numpy

    return soup_from_numpy(
        **scene_fields(v0, e0, e1, surface, specular, diffuse), device=device
    )


def soup_from_scene(scene, device=None) -> TriangleSoup:
    """Build a TriangleSoup on ``device`` (None: the card) from a compiled
    host Scene."""
    return soup_from_arrays(
        scene.v0,
        scene.e0,
        scene.e1,
        scene.tri_surface,
        scene.specular,
        scene.diffuse,
        device=device,
    )


def _content(scene) -> tuple:
    """Every input a soup reads, exactly: the dtype, shape and bytes of
    tri_verts (padding rows included), tri_surface, specular and
    diffuse."""
    return tuple((a.dtype.str, a.shape, a.tobytes()) for a in map(
        np.asarray, (scene.tri_verts, scene.tri_surface, scene.specular, scene.diffuse)))


class SoupCache:
    """The soups of the last ``size`` scenes and devices asked for, the
    least recently used evicted first. A soup is found by its device and
    by a byte comparison of the scene's inputs (``_content``) against the
    copy kept with it, so an equal scene gets it and a scene changed in
    place gets a new one. Equal inputs build byte-equal tables, and no
    caller writes into a soup's tensors, so a kept soup serves every
    later call."""

    def __init__(self, size: int):
        self.size = size
        self.entries: list = []  # [(key, soup)], the most recent last

    def get(self, scene, device=None) -> tuple[TriangleSoup, bool]:
        """(the soup of ``scene`` on ``device``, whether it was kept)"""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (dev, _content(scene))
        for i, (k, soup) in enumerate(self.entries):
            if k == key:
                self.entries.append(self.entries.pop(i))
                return soup, True
        soup = soup_from_scene(scene, device=dev)
        self.entries = [*self.entries, (key, soup)][-self.size:]
        return soup, False


# the process's soups: a few scenes (a hall's is ~14 MB on the card)
_SOUPS = SoupCache(4)


def cached_soup(scene, device=None) -> tuple[TriangleSoup, bool]:
    """soup_from_scene's soup, built once per scene content and device in
    a process (SoupCache): (soup, whether it was kept), counted as
    sweep_table.hits or sweep_table.builds."""
    soup, hit = _SOUPS.get(scene, device)
    profiling.count("sweep_table.hits" if hit else "sweep_table.builds")
    return soup, hit


class Hit(NamedTuple):
    """Result of a closest-hit sweep. Misses have t = +inf and hit = False."""

    t: torch.Tensor      # (M,) float32
    index: torch.Tensor  # (M,) int64 original triangle index (0 on miss)
    hit: torch.Tensor    # (M,) bool


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def moller_trumbore(origins, dirs, v0, e0, e1):
    """Vectorised Moller-Trumbore (kernel.cpp:62-88). Returns (t, valid);
    the sign of t is not checked here."""
    pvec = _cross(dirs, e1)
    det = _dot(e0, pvec)
    degenerate = torch.abs(det) < EPSILON
    invdet = 1.0 / torch.where(degenerate, 1.0, det)
    tvec = origins - v0
    u = invdet * _dot(tvec, pvec)
    qvec = _cross(tvec, e0)
    v = invdet * _dot(dirs, qvec)
    t = invdet * _dot(e1, qvec)
    valid = (
        ~degenerate
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
    )
    return t, valid


def intersect_triangle(origins, dirs, tri_verts):
    """Single-triangle intersection for image-source path validation
    (triangle_vert_intersection, kernel.cpp:62-88): raw t, 0 where the
    reference returns 0 (degenerate or outside)."""
    v0 = tri_verts[..., 0, :]
    e0 = tri_verts[..., 1, :] - v0
    e1 = tri_verts[..., 2, :] - v0
    t, valid = moller_trumbore(origins, dirs, v0, e0, e1)
    return torch.where(valid, t, 0.0)


def _slab(origins, dirs, inv, box):
    """(tn, tf): entry and exit of the rays' lines through the AABB ``box``
    (..., 8), which broadcasts against the rays' columns ``origins[..., a]``.
    The kernel's slab test, op for op."""
    tn = tf = None
    for a in range(3):
        o = origins[..., a]
        lo = box[..., a]
        hi = box[..., 3 + a]
        near = (lo - o) * inv[..., a]
        far = (hi - o) * inv[..., a]
        tna = torch.minimum(near, far)
        tfa = torch.maximum(near, far)
        zero = torch.abs(dirs[..., a]) < 1e-30
        inside = (o >= lo) & (o <= hi)
        inf = torch.full_like(tna, float("inf"))
        tna = torch.where(zero, torch.where(inside, -inf, inf), tna)
        tfa = torch.where(zero, torch.where(inside, inf, -inf), tfa)
        tn = tna if tn is None else torch.maximum(tn, tna)
        tf = tfa if tf is None else torch.minimum(tf, tfa)
    return tn, tf


def _slab_pass(origins, dirs, inv, box, best_t):
    """Bool mask: the ray's segment [max(tn, EPSILON), min(tf, best_t)]
    meets the block AABB ``box`` (one box, or one per (slice, ray) pair)."""
    tn, tf = _slab(origins, dirs, inv, box)
    return (tf >= torch.clamp(tn, min=EPSILON)) & (tn <= best_t)


def _tile_min(o, d, tiles):
    """Closest valid hit of the rays (k, R, 3) of k groups, each group
    against its own block of packed rows (k, B, 16): returns ((k, R) t_min,
    (k, R) lowest original index at t_min)."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    r = tiles.permute(2, 0, 1)[:, :, None, :]  # (16, k, 1, B)
    ou = r[0] * ox + r[1] * oy + r[2] * oz + r[10]
    ov = r[3] * ox + r[4] * oy + r[5] * oz + r[11]
    ow = r[6] * ox + r[7] * oy + r[8] * oz + r[12]
    du = r[0] * dx + r[1] * dy + r[2] * dz
    dv = r[3] * dx + r[4] * dy + r[5] * dz
    dw = r[6] * dx + r[7] * dy + r[8] * dz
    degenerate = torch.abs(dw) < EPSILON
    t = -ow / torch.where(degenerate, 1.0, dw)
    u = ou + t * du
    v = ov + t * dv
    valid = (
        (~degenerate)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > EPSILON)
    )
    t = torch.where(valid, t, float("inf"))
    tmin = torch.amin(t, dim=-1)
    oidx = r[9].to(torch.int32)
    cand = torch.amin(
        torch.where(t <= tmin[..., None], oidx, _BIG_I32), dim=-1
    )
    return tmin, cand


def sweep_slices(m: int, nblocks: int, decided: bool = False) -> int:
    """Table slices S of a sweep of ``m`` rays over ``nblocks`` blocks:
    CLOSEST_SLICES for closest-hit batches; for decided batches (t_decide
    given) as many as it takes for (ray groups x S) thread blocks to reach
    DECIDED_TARGET_CTAS. At most nblocks // 2, so that every slice holds
    at least two blocks and can cull the later ones by its own best."""
    groups = max(1, -(-m // SWEEP_RAYS))
    want = -(-DECIDED_TARGET_CTAS // groups) if decided else CLOSEST_SLICES
    return max(1, min(want, nblocks // 2))


def table_order(m: int, nblocks: int, device) -> torch.Tensor:
    """(groups, nblocks) int32: every group walks the blocks in table
    order."""
    groups = -(-m // SWEEP_RAYS)
    return (
        torch.arange(nblocks, dtype=torch.int32, device=device)
        .expand(groups, nblocks)
        .contiguous()
    )


def block_order(origins, dirs, t_max, block_aabb) -> torch.Tensor:
    """(groups, nblocks) int32 near-to-far block order of each group of
    SWEEP_RAYS consecutive rays.

    The group's first live ray (t_max > 0, every ray where t_max is None;
    the first row of a dead group) ranks each block by where its line
    enters the block's AABB (0 from inside); blocks it does not meet come
    last. Ties go to the lower block index. Only elementwise IEEE
    operations and an integer sort are used, so every device computes the
    same table from the same inputs."""
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    groups = -(-m // SWEEP_RAYS)
    dev = origins.device
    live = torch.zeros((groups * SWEEP_RAYS,), dtype=torch.uint8, device=dev)
    live[:m] = True if t_max is None else t_max > 0
    first = torch.argmax(live.view(groups, SWEEP_RAYS), dim=1)
    rep = torch.clamp(
        torch.arange(groups, device=dev) * SWEEP_RAYS + first, max=max(m - 1, 0)
    )
    o = origins[rep][:, None, :]
    d = dirs[rep][:, None, :]
    tn, tf = _slab(o, d, 1.0 / d, block_aabb)  # (groups, nb)
    meets = tf >= torch.clamp(tn, min=EPSILON)
    rank = torch.where(meets, torch.clamp(tn, min=0.0), float("inf"))
    # non-negative float bits order as the floats do (& clears -0.0's sign)
    bits = rank.view(torch.int32) & 0x7FFFFFFF
    key = bits.to(torch.int64) * nb + torch.arange(nb, device=dev)
    return torch.argsort(key, dim=1).to(torch.int32)


def block_keep(origins, dirs, t_max, t_decide, block_aabb) -> torch.Tensor:
    """(groups, nblocks) bool: the blocks that some ray of each group of
    SWEEP_RAYS consecutive rays can need, the plain version of the order
    kernel's cull. A ray can need a block when the sweep's entry test
    passes at the ray's bound: it is live (t_max > 0), undecided there
    (t_max >= t_decide) and its segment [EPSILON, t_max] meets the block's
    AABB. The running best only falls from t_max, so no slice ever sweeps
    a block that every ray of its group fails here. t_max None: +inf;
    t_decide None: 0. The (ray, block) tests run in chunks of
    PLAIN_CULL_CHUNK."""
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    groups = -(-m // SWEEP_RAYS)
    dev = origins.device
    t_max, t_decide = _bounds(m, t_max, t_decide, dev)
    cand = (t_max > 0) & (t_max >= t_decide)
    inv = 1.0 / dirs
    keep = torch.zeros((groups, nb), dtype=torch.bool, device=dev)
    step = SWEEP_RAYS * max(1, PLAIN_CULL_CHUNK // (SWEEP_RAYS * max(nb, 1)))
    for r0 in range(0, m, step):
        rows = slice(r0, min(m, r0 + step))
        need = cand[rows, None] & _slab_pass(
            origins[rows, None, :], dirs[rows, None, :], inv[rows, None, :],
            block_aabb, t_max[rows, None],
        )  # (rays, nb)
        pad = -need.shape[0] % SWEEP_RAYS
        need = torch.cat([need, need.new_zeros((pad, nb))])
        g0 = r0 // SWEEP_RAYS
        keep[g0 : g0 + need.shape[0] // SWEEP_RAYS] = need.view(
            -1, SWEEP_RAYS, nb).any(dim=1)
    return keep


def cull_order(order, keep, slices: int):
    """(order, counts): each slice's run of ``order`` (slice_bounds) with
    the blocks that ``keep`` (block_keep) marks first and the others
    after, each in the order's order, and counts (groups, slices) int32,
    the kept blocks of each run: the plain version of the order kernel's
    culled rows."""
    groups, nb = order.shape
    kept = torch.gather(keep, 1, order.long())
    run = torch.empty((nb,), dtype=torch.int64, device=order.device)
    for s, (b, e) in enumerate(slice_bounds(nb, slices)):
        run[b:e] = s
    perm = torch.sort(run * 2 + (~kept).long(), dim=1, stable=True).indices
    counts = torch.zeros((groups, slices), dtype=torch.int32, device=order.device)
    counts.index_add_(1, run, kept.to(torch.int32))
    return torch.gather(order, 1, perm), counts


class Schedule(NamedTuple):
    """A sweep's schedule (sweep_schedule)."""

    order: torch.Tensor   # (groups, nblocks) int32, each slice's run culled
    slices: int
    counts: torch.Tensor  # (groups, slices) int32 entries each slice walks


def sweep_schedule(origins, dirs, t_max, t_decide, soup, pair_sums=None) -> Schedule:
    """(order, slices, counts) of a sweep against ``soup``: sweep_slices
    (decided where t_decide is given), block_order culled by block_keep
    (cull_order); for CUDA tensors all of it in one launch of the order
    kernel (intersect_cuda.block_order_cuda). The dispatcher computes it
    once and hands it to whichever version runs. t_max None: every ray is
    live; t_decide None: 0. pair_sums (profiling.pair_sums): the kept
    entries and groups x nblocks are added into
    pair_sums[ORDER_ENTRIES] and the slot after it."""
    m = origins.shape[0]
    nb = soup.block_aabb.shape[0]
    slices = sweep_slices(m, nb, t_decide is not None)
    if origins.is_cuda:
        from .intersect_cuda import block_order_cuda

        order, counts = block_order_cuda(
            origins, dirs, t_max, soup.block_aabb, soup.super_aabb, slices,
            t_decide=t_decide, pair_sums=pair_sums,
        )
        return Schedule(order, slices, counts)
    order, counts = cull_order(
        block_order(origins, dirs, t_max, soup.block_aabb),
        block_keep(origins, dirs, t_max, t_decide, soup.block_aabb),
        slices,
    )
    if pair_sums is not None:
        pair_sums[profiling.ORDER_ENTRIES] += counts.sum()
        pair_sums[profiling.ORDER_ENTRIES + 1] += counts.shape[0] * nb
    return Schedule(order, slices, counts)


def slice_bounds(nblocks: int, slices: int):
    """[(first, end)) positions of each slice in a group's order row."""
    return [
        (s * nblocks // slices, (s + 1) * nblocks // slices)
        for s in range(slices)
    ]


_I32_MIN = -(1 << 31)


def pack_keys(best_t, best_i):
    """Merge keys of (t, index) results: the CUDA kernel's 64-bit key
    (float bits of t << 32 | index as uint32, -1 as 0xFFFFFFFF), shifted
    by -2^63 so that int64 order is the uint64 order. For t > 0 the key
    order is the tie rule: smallest t, then lowest index, with -1 last."""
    hi = (best_t.contiguous().view(torch.int32) ^ _I32_MIN).to(torch.int64)
    lo = best_i.to(torch.int64) & 0xFFFFFFFF
    return hi * (1 << 32) + lo


def unpack_keys(key):
    """Inverse of pack_keys: (t float32, index int32, 0xFFFFFFFF -> -1)."""
    hi = (key >> 32).to(torch.int32) ^ _I32_MIN
    lo = key & 0xFFFFFFFF
    idx = torch.where(lo == 0xFFFFFFFF, -1, lo).to(torch.int32)
    return hi.view(torch.float32), idx


def check_schedule(order, slices, m, nblocks, counts=None):
    """Raise ValueError unless (order, slices, counts) is a schedule for
    ``m`` rays over ``nblocks`` blocks (counts None: every entry)."""
    groups = -(-m // SWEEP_RAYS)
    if tuple(order.shape) != (groups, nblocks) or order.dtype != torch.int32:
        raise ValueError(
            f"order must be int32 of shape {(groups, nblocks)}, got "
            f"{order.dtype} {tuple(order.shape)}"
        )
    if not 1 <= slices <= max(nblocks, 1):
        raise ValueError(f"slices must lie in [1, {nblocks}], got {slices}")
    if counts is not None and (
        tuple(counts.shape) != (groups, slices) or counts.dtype != torch.int32
    ):
        raise ValueError(
            f"counts must be int32 of shape {(groups, slices)}, got "
            f"{counts.dtype} {tuple(counts.shape)}"
        )


def closest_hit_plain(
    origins, dirs, packed, block_aabb, t_max, t_decide, order, slices, *,
    counts=None, with_stats=False, pair_sums=None, kinds=(),
):
    """The kernel's plain version: raw (best_t (M,) f32, best_i (M,) i32,
    -1 = none) for rays (M, 3) against the packed table, with per-ray
    bounds ``t_max`` and any-hit thresholds ``t_decide`` (M,) f32, on the
    schedule (``order``, ``slices``, ``counts``) of sweep_schedule.

    Each group of SWEEP_RAYS rays walks its row of ``order``, cut into
    ``slices`` contiguous runs (slice_bounds), of each of which it walks
    the first counts[group, slice] entries (counts None: the whole run);
    every slice keeps its own running best, seeded from t_max. At each
    block's entry a ray takes part in the block when its bound is
    positive, it is undecided in that slice
    (``best_t >= t_decide``) and it passes the slab test against the
    slice's running ``best_t``. The slices' results are merged by the
    minimum of their pack_keys. The slices run position by position, all
    at once; the (slice, group) pairs in which some ray takes part are
    swept in chunks, each group's rays against the one block they share.

    with_stats=True also returns (M,) int64 executed pair tests per ray
    (SWEEP_BLOCK per block and slice the ray took part in). With
    ``pair_sums`` (a (PAIR_SUMS,) int64 tensor, profiling.pair_sums) those
    of the rows [start, end) of each (kind, start, end) of ``kinds`` are
    added into pair_sums[kind], and the number of those rows that are live
    (t_max > 0) into pair_sums[LIVE_ROWS + kind], as the kernel's epilogue
    adds them."""
    count_rows = with_stats or pair_sums is not None
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    blk = packed.shape[0] // nb
    dev = origins.device
    check_schedule(order, slices, m, nb, counts)
    groups = order.shape[0]
    pad = groups * SWEEP_RAYS - m

    def by_group(x, fill):
        # (groups, SWEEP_RAYS, ...); the padding rows are dead (t_max = 0)
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
        return x.view(groups, SWEEP_RAYS, *x.shape[1:])

    o = by_group(origins, 0.0)
    d = by_group(dirs, 1.0)
    t_max = by_group(t_max.to(torch.float32), 0.0)
    t_decide = by_group(t_decide, 0.0)
    tiles = packed.view(nb, blk, 16)
    best_t = t_max[None].repeat(slices, 1, 1)  # (S, groups, SWEEP_RAYS)
    best_i = torch.full(best_t.shape, -1, dtype=torch.int32, device=dev)
    executed = torch.zeros(t_max.shape, dtype=torch.int64, device=dev)
    inv = 1.0 / d
    live = t_max > 0
    order = order.long()
    bounds = slice_bounds(nb, slices)
    walk = None if counts is None else counts.long().T  # (S, groups)
    steps = max(e - b for b, e in bounds)
    if walk is not None:
        steps = int(walk.max()) if walk.numel() else 0
    chunk = max(1, PLAIN_RAY_CHUNK // SWEEP_RAYS)
    for p in range(steps):
        sl = [s for s, (b, e) in enumerate(bounds) if b + p < e]
        cols = torch.tensor([bounds[s][0] + p for s in sl], device=dev)
        sl = torch.tensor(sl, device=dev)
        blocks = order[:, cols].T  # (S', groups)
        bt = best_t[sl]
        active = (
            live
            & (bt >= t_decide)
            & _slab_pass(o, d, inv, block_aabb[blocks][:, :, None, :], bt)
        )  # (S', groups, SWEEP_RAYS)
        if walk is not None:
            active &= (p < walk[sl])[..., None]
        if count_rows:
            executed += blk * active.sum(dim=0)
        ks, gs = torch.nonzero(active.any(dim=-1), as_tuple=True)
        for c0 in range(0, gs.numel(), chunk):
            k = ks[c0 : c0 + chunk]
            g = gs[c0 : c0 + chunk]
            tmin, cand = _tile_min(o[g], d[g], tiles[blocks[k, g]])
            s = sl[k]
            bt_f = best_t[s, g]
            bi_f = best_i[s, g]
            better = active[k, g] & (
                (tmin < bt_f)
                | (
                    (tmin == bt_f)
                    & torch.isfinite(tmin)
                    & ((cand < bi_f) | (bi_f < 0))
                )
            )
            best_t[s, g] = torch.where(better, tmin, bt_f)
            best_i[s, g] = torch.where(better, cand, bi_f)
    keys = pack_keys(best_t.view(slices, -1), best_i.view(slices, -1))
    out_t, out_i = unpack_keys(torch.amin(keys[:, :m], dim=0))
    executed = executed.view(-1)[:m]
    if pair_sums is not None:
        live_rows = live.view(-1)[:m]
        for kind, start, end in kinds:
            pair_sums[kind] += executed[start:end].sum()
            pair_sums[profiling.LIVE_ROWS + kind] += live_rows[start:end].sum()
    if with_stats:
        return out_t, out_i, executed
    return out_t, out_i


def hit_from_raw(best_t, best_i) -> Hit:
    """The Hit of raw sweep results (best_t f32, best_i i32, -1 = none):
    t = +inf and index 0 on a miss (rayverb_tpu/ops/intersect_pallas.py:
    686-690). The plain version of the CUDA kernel's epilogue, which writes
    these fields itself."""
    found = best_i >= 0
    return Hit(
        t=torch.where(found, best_t, float("inf")),
        index=torch.clamp(best_i, min=0).to(torch.int64),
        hit=found,
    )


def raw_from_hit(hit: Hit, t_max=None):
    """Inverse of hit_from_raw for a sweep with per-ray bounds ``t_max``
    (None: +inf): (best_t, best_i), t_max and -1 on a miss, bit for bit
    the raw results that the Hit came from."""
    if t_max is None:
        t_max = torch.full_like(hit.t, float("inf"))
    return (torch.where(hit.hit, hit.t, t_max),
            torch.where(hit.hit, hit.index, -1).to(torch.int32))


def _bounds(m, t_max, t_decide, device):
    if t_max is None:
        t_max = torch.full((m,), float("inf"), device=device)
    if t_decide is None:
        t_decide = torch.zeros((m,), device=device)
    return (
        t_max.to(torch.float32).contiguous(),
        t_decide.to(torch.float32).contiguous(),
    )


def runs_cuda(x: torch.Tensor, impl: str) -> bool:
    """Whether ``impl`` sends the work on ``x`` to the CUDA kernels: 'cuda',
    or 'auto' on CUDA tensors; 'plain', or 'auto' on the CPU, runs the plain
    PyTorch version. closest_hit and the trace's sort keys dispatch by it."""
    return impl == "cuda" or (impl == "auto" and x.is_cuda)


def closest_hit(
    origins,
    dirs,
    soup: TriangleSoup,
    *,
    impl: str = "auto",
    t_max=None,
    t_decide=None,
    with_stats: bool = False,
    pair_sums=None,
    kinds=(),
):
    """Closest hit of rays (M, 3) against the scene.

    impl: 'auto' launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; 'cuda' always launches the kernel (and
    raises on CPU tensors); 'plain' always runs the plain version.

    t_max (M,), optional, inclusive per-ray bound. t_decide (M,), optional
    any-hit thresholds: a row whose best drops strictly below its threshold
    stops refining, so its (t, index) may be a witness blocker rather than
    the closest; pass it only for rows whose consumer reads the verdict.

    With the kernel a call is two launches, the order kernel (the order
    and its cull) and the sweep (which writes the Hit and adds the
    counters).

    with_stats=True returns (Hit, executed pair tests per ray). pair_sums
    (a (PAIR_SUMS,) int64 tensor, profiling.pair_sums) and ``kinds``: the
    executed pair tests of the rows [start, end) of each (kind, start, end) are
    added into pair_sums[kind], and its live rows into pair_sums[LIVE_ROWS
    + kind] (closest_hit_plain); the order's kept entries and groups x
    nblocks into pair_sums[ORDER_ENTRIES] and the slot after it
    (sweep_schedule).

    A call is the span rv.closest_hit (attrs rows, kinds) with the spans
    rv.block_order and rv.sweep, the host side of the two launches, and
    adds to the counters closest_hit.calls and closest_hit.rows."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"impl must be 'auto', 'cuda' or 'plain', not {impl!r}")
    m = origins.shape[0]
    profiling.count("closest_hit.calls")
    profiling.count("closest_hit.rows", m)
    with profiling.span("rv.closest_hit", rows=m, kinds=kinds):
        origins = origins.to(torch.float32).contiguous()
        dirs = dirs.to(torch.float32).contiguous()
        # an absent bound stays absent: the kernels read +inf or 0
        t_max, t_decide = (
            None if x is None else x.to(torch.float32).contiguous()
            for x in (t_max, t_decide)
        )
        with profiling.span("rv.block_order"):
            order, slices, counts = sweep_schedule(
                origins, dirs, t_max, t_decide, soup, pair_sums
            )
        if runs_cuda(origins, impl):
            from .intersect_cuda import closest_hit_cuda

            with profiling.span("rv.sweep"):
                return closest_hit_cuda(
                    origins, dirs, soup.packed, soup.block_aabb, t_max, t_decide,
                    order, slices, counts=counts, with_stats=with_stats,
                    pair_sums=pair_sums, kinds=kinds,
                )
        t_max, t_decide = _bounds(m, t_max, t_decide, origins.device)
        with profiling.span("rv.sweep"):
            out = closest_hit_plain(
                origins, dirs, soup.packed, soup.block_aabb, t_max, t_decide, order,
                slices, counts=counts, with_stats=with_stats, pair_sums=pair_sums,
                kinds=kinds,
            )
            hit = hit_from_raw(out[0], out[1])
        return (hit, out[2]) if with_stats else hit


def visible(begin, point, soup: TriangleSoup, *, impl: str = "auto"):
    """Mutual visibility of two points (point_intersection,
    kernel.cpp:267-296): true when no triangle lies strictly between them."""
    diff = point - begin
    mag = torch.linalg.norm(diff, dim=-1)
    safe = torch.where(mag[..., None] > 0, mag[..., None], 1.0)
    hit = closest_hit(
        begin, diff / safe, soup, impl=impl, t_max=mag * 1.001 + 0.01
    )
    return (~hit.hit) | (hit.t > mag)
