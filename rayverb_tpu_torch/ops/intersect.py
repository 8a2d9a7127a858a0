"""Closest-hit ray/triangle queries: the scene table, the plain sweep and
the dispatcher (PyTorch counterpart of rayverb_tpu/ops/intersect.py).

Every geometric question of the trace (direct path, bounce hits, mic shadow
rays, image-source segment validation, image mic visibility) is one batched
closest-hit sweep over the scene's packed Woop rows. The sweep has two
implementations with one contract:

  - ``closest_hit_plain``: chunked brute-force PyTorch over the packed rows,
    the kernel's plain version (CPU tensors, tests, on-card comparisons)
  - ``intersect_cuda.closest_hit_cuda``: the hand-written CUDA kernel
    (csrc/closest_hit.cu), taken for every CUDA tensor

Contract (that of rayverb_tpu/ops/intersect_pallas.py::_kernel):
  - pair test on the Woop rows of ``build_sweep_table``: ``|n.d| < EPSILON``
    is degenerate, strict barycentric bounds, ``t > EPSILON``
  - ``best_t`` starts at the per-ray ``t_max`` (inclusive); ``best_i`` at -1
  - equal ``t`` resolves to the lowest ORIGINAL triangle index
  - a ray stops refining once ``best_t < t_decide`` (any-hit verdict rows)
  - per ray and per triangle block, an AABB slab test against the running
    ``best_t`` skips blocks that cannot improve the ray (conservative)

Both implementations walk the triangle blocks in table order and decide,
per ray and at each block's entry, whether the block runs. Their arithmetic
is the same operation for operation, so on the same inputs they return the
same bits (the kernel is built without FMA contraction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import EPSILON
from ..utils.directions import _morton3

# Triangle rows per sweep block and per block AABB (the JAX package's
# default RAYVERB_SWEEP_BLOCK). The CUDA kernel stages one block per step.
SWEEP_BLOCK = 128

# Rays per plain-sweep chunk: bounds the (rays, SWEEP_BLOCK) planes.
PLAIN_RAY_CHUNK = 1 << 15

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


def soup_from_scene(scene, device="cpu") -> TriangleSoup:
    """Build a TriangleSoup on ``device`` from a compiled host Scene."""
    from ..params import soup_from_numpy

    return soup_from_numpy(
        **scene_fields(
            scene.v0,
            scene.e0,
            scene.e1,
            scene.tri_surface,
            scene.specular,
            scene.diffuse,
        ),
        device=device,
    )


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


def _slab_pass(origins, dirs, inv, box, best_t):
    """(M,) bool: the ray's segment [max(tn, EPSILON), min(tf, best_t)] meets
    the block AABB ``box`` (8,). The kernel's slab test, op for op."""
    tn = tf = None
    for a in range(3):
        o = origins[:, a]
        lo = box[a]
        hi = box[3 + a]
        near = (lo - o) * inv[:, a]
        far = (hi - o) * inv[:, a]
        tna = torch.minimum(near, far)
        tfa = torch.maximum(near, far)
        zero = torch.abs(dirs[:, a]) < 1e-30
        inside = (o >= lo) & (o <= hi)
        inf = torch.full_like(tna, float("inf"))
        tna = torch.where(zero, torch.where(inside, -inf, inf), tna)
        tfa = torch.where(zero, torch.where(inside, inf, -inf), tfa)
        tn = tna if tn is None else torch.maximum(tn, tna)
        tf = tfa if tf is None else torch.minimum(tf, tfa)
    return (tf >= torch.clamp(tn, min=EPSILON)) & (tn <= best_t)


def _tile_min(o, d, tile):
    """Closest valid hit of rays (k, 3) against one block's packed rows
    (B, 16): returns ((k,) t_min, (k,) lowest original index at t_min)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = tile.T[:, None, :]  # (16, 1, B)
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
    tmin = torch.amin(t, dim=1)
    oidx = r[9].to(torch.int32)
    cand = torch.amin(
        torch.where(t <= tmin[:, None], oidx, _BIG_I32), dim=1
    )
    return tmin, cand


def closest_hit_plain(
    origins, dirs, packed, block_aabb, t_max, t_decide, *, with_stats=False
):
    """The kernel's plain version: raw (best_t (M,) f32, best_i (M,) i32,
    -1 = none) for rays (M, 3) against the packed table, with per-ray
    bounds ``t_max`` and any-hit thresholds ``t_decide`` (M,) f32.

    Blocks run in table order; at each block's entry a ray takes part when
    its bound is positive, it is undecided (``best_t >= t_decide``) and it
    passes the slab test against its running ``best_t``. Participating rays
    are gathered and swept in chunks of PLAIN_RAY_CHUNK.

    with_stats=True also returns (M,) int64 executed pair tests per ray
    (SWEEP_BLOCK per block the ray took part in)."""
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    blk = packed.shape[0] // nb
    best_t = t_max.to(torch.float32).clone()
    best_i = torch.full((m,), -1, dtype=torch.int32, device=origins.device)
    executed = (
        torch.zeros((m,), dtype=torch.int64, device=origins.device)
        if with_stats
        else None
    )
    inv = 1.0 / dirs
    live = t_max > 0
    for b in range(nb):
        active = (
            live
            & (best_t >= t_decide)
            & _slab_pass(origins, dirs, inv, block_aabb[b], best_t)
        )
        rows = torch.nonzero(active).squeeze(1)
        if rows.numel() == 0:
            continue
        if executed is not None:
            executed[rows] += blk
        tile = packed[b * blk : (b + 1) * blk]
        for c0 in range(0, rows.numel(), PLAIN_RAY_CHUNK):
            r = rows[c0 : c0 + PLAIN_RAY_CHUNK]
            tmin, cand = _tile_min(origins[r], dirs[r], tile)
            bt = best_t[r]
            bi = best_i[r]
            better = (tmin < bt) | (
                (tmin == bt)
                & torch.isfinite(tmin)
                & ((cand < bi) | (bi < 0))
            )
            best_t[r] = torch.where(better, tmin, bt)
            best_i[r] = torch.where(better, cand, bi)
    if with_stats:
        return best_t, best_i, executed
    return best_t, best_i


def _bounds(m, t_max, t_decide, device):
    if t_max is None:
        t_max = torch.full((m,), float("inf"), device=device)
    if t_decide is None:
        t_decide = torch.zeros((m,), device=device)
    return (
        t_max.to(torch.float32).contiguous(),
        t_decide.to(torch.float32).contiguous(),
    )


def closest_hit(
    origins,
    dirs,
    soup: TriangleSoup,
    *,
    impl: str = "auto",
    t_max=None,
    t_decide=None,
    with_stats: bool = False,
):
    """Closest hit of rays (M, 3) against the scene.

    impl: 'auto' launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; 'cuda' always launches the kernel (and
    raises on CPU tensors); 'plain' always runs the plain version.

    t_max (M,), optional, inclusive per-ray bound. t_decide (M,), optional
    any-hit thresholds: a row whose best drops strictly below its threshold
    stops refining, so its (t, index) may be a witness blocker rather than
    the closest; pass it only for rows whose consumer reads the verdict.

    with_stats=True (plain version only) returns (Hit, executed pair tests
    per ray); the kernel's counters are not ported yet."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"impl must be 'auto', 'cuda' or 'plain', not {impl!r}")
    origins = origins.to(torch.float32).contiguous()
    dirs = dirs.to(torch.float32).contiguous()
    t_max, t_decide = _bounds(origins.shape[0], t_max, t_decide, origins.device)
    use_kernel = impl == "cuda" or (impl == "auto" and origins.is_cuda)
    executed = None
    if use_kernel:
        if with_stats:
            raise NotImplementedError(
                "the CUDA sweep's executed-pair counters are not ported yet"
            )
        from .intersect_cuda import closest_hit_cuda

        best_t, best_i = closest_hit_cuda(
            origins, dirs, soup.packed, soup.block_aabb, t_max, t_decide
        )
    else:
        out = closest_hit_plain(
            origins,
            dirs,
            soup.packed,
            soup.block_aabb,
            t_max,
            t_decide,
            with_stats=with_stats,
        )
        best_t, best_i = out[0], out[1]
        executed = out[2] if with_stats else None
    found = best_i >= 0
    hit = Hit(
        t=torch.where(found, best_t, float("inf")),
        index=torch.clamp(best_i, min=0).to(torch.int64),
        hit=found,
    )
    return (hit, executed) if with_stats else hit


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
