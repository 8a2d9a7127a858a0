"""The reference's closest-hit query: every ray against every triangle whose
block's bounding box its segment meets, the smallest t kept.

A pair test is the published raytracer's (kernel.cpp:62-88) in the
precomputed-transform form: for a triangle (v0, e0 = v1 - v0, e1 = v2 - v0)
with n = e0 x e1, row_u = (e1 x n) / |n|^2 and row_v = (n x e0) / |n|^2,
worked out in float64 and rounded once,

    t = -(n.o - n.v0) / (n.d),   u = row_u.(o + t d) - row_u.v0,   v likewise,

accepted when |n.d| >= EPSILON, u >= 0, v >= 0, u + v <= 1, u <= 1 and
EPSILON < t <= t_max. The closest accepted t wins, and equal t goes to the
lower triangle index. Triangles are grouped into blocks of BLOCK along a
Morton curve of their centroids and blocks into groups of GROUP; a ray tests
only the triangles of blocks whose padded boxes its segment meets, nearest
box first, and skips a box it enters beyond its best hit so far, which
changes no answer. Arithmetic runs in the dtype the caller gives (float32,
or bfloat16 for the lower-precision control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPSILON = 1e-4
BLOCK = 32
GROUP = 32
# rows per culling chunk, and (ray, block) pairs per test chunk
ROW_CHUNK = 1 << 18
PAIR_CHUNK = 1 << 18
_NONE = (1 << 63) - 1


class Table(NamedTuple):
    rows: torch.Tensor       # (NB, 12, BLOCK) row_u, row_v, n, bu, bv, bw of each
                             # block's triangles; zero where empty
    blocks: torch.Tensor     # (NB, BLOCK) triangle ids, T where empty
    lo: torch.Tensor         # (NB, 3) padded block boxes
    hi: torch.Tensor
    groups: torch.Tensor     # (NG, GROUP) block ids, -1 where empty
    glo: torch.Tensor        # (NG, 3)
    ghi: torch.Tensor


def _morton(q):
    def spread(x):
        x = x.astype(np.uint64)
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
            x = (x | (x << np.uint64(shift))) & np.uint64(mask)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))


def _boxes(lo, hi):
    pad = 1e-3 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    return lo - pad, hi + pad


def build_table(v0, v1, v2, dtype, device) -> Table:
    """The triangle rows and the block boxes of a scene (host numpy float32
    vertices) on ``device``."""
    v0 = np.asarray(v0, np.float32)
    e0 = np.asarray(v1, np.float32) - v0
    e1 = np.asarray(v2, np.float32) - v0
    a, b, c = (x.astype(np.float64) for x in (v0, e0, e1))
    n = np.cross(b, c)
    nn = np.einsum("ij,ij->i", n, n)
    ok = nn > 0
    safe = np.where(ok, nn, 1.0)[:, None]
    ru = np.where(ok[:, None], np.cross(c, n) / safe, 0.0)
    rv = np.where(ok[:, None], np.cross(n, b) / safe, 0.0)
    t = v0.shape[0]
    rows = np.zeros((t + 1, 12), np.float64)
    rows[:t, 0:3] = ru
    rows[:t, 3:6] = rv
    rows[:t, 6:9] = n
    rows[:t, 9] = -np.einsum("ij,ij->i", ru, a)
    rows[:t, 10] = -np.einsum("ij,ij->i", rv, a)
    rows[:t, 11] = -np.einsum("ij,ij->i", n, a)
    rows = rows.astype(np.float32)

    pts = np.stack([v0, v0 + e0, v0 + e1], axis=1)  # (T, 3, 3)
    cen = pts.mean(axis=1)
    span = np.maximum(cen.max(axis=0) - cen.min(axis=0), 1e-9)
    q = np.clip((cen - cen.min(axis=0)) / span * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton(q), kind="stable")
    nb = -(-t // BLOCK)
    blocks = np.full(nb * BLOCK, t, np.int64)
    blocks[:t] = order
    blocks = blocks.reshape(nb, BLOCK)
    real = blocks < t
    bp = pts[np.minimum(blocks, t - 1)]  # (NB, BLOCK, 3, 3)
    lo = np.where(real[..., None, None], bp, np.inf).min(axis=(1, 2))
    hi = np.where(real[..., None, None], bp, -np.inf).max(axis=(1, 2))
    ng = -(-nb // GROUP)
    groups = np.full(ng * GROUP, -1, np.int64)
    groups[:nb] = np.arange(nb)
    groups = groups.reshape(ng, GROUP)
    greal = groups >= 0
    glo = np.where(greal[..., None], lo[np.maximum(groups, 0)], np.inf).min(axis=1)
    ghi = np.where(greal[..., None], hi[np.maximum(groups, 0)], -np.inf).max(axis=1)
    lo, hi = _boxes(lo, hi)
    glo, ghi = _boxes(glo, ghi)

    def dev(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    by_block = np.ascontiguousarray(rows[blocks].transpose(0, 2, 1))  # (NB, 12, BLOCK)
    return Table(dev(by_block), dev(blocks, torch.int64), dev(lo), dev(hi),
                 dev(groups, torch.int64), dev(glo), dev(ghi))


def _slab(o, d, lo, hi):
    """(entry, exit) t of the lines o + t d through the boxes [lo, hi];
    o, d (..., 3) broadcast against lo, hi (..., 3)."""
    tn = torch.full(torch.broadcast_shapes(o.shape, lo.shape)[:-1], -float("inf"),
                    dtype=o.dtype, device=o.device)
    tf = torch.full_like(tn, float("inf"))
    for k in range(3):
        ok, dk = o[..., k], d[..., k]
        flat = dk.abs() < 1e-30
        inv = 1.0 / torch.where(flat, torch.ones_like(dk), dk)
        a = (lo[..., k] - ok) * inv
        b = (hi[..., k] - ok) * inv
        inside = (ok >= lo[..., k]) & (ok <= hi[..., k])
        near = torch.where(flat, torch.where(inside, -float("inf"), float("inf")),
                           torch.minimum(a, b))
        far = torch.where(flat, torch.where(inside, float("inf"), -float("inf")),
                          torch.maximum(a, b))
        tn = torch.maximum(tn, near)
        tf = torch.minimum(tf, far)
    return tn, tf


def _meets(tn, tf, tmax):
    """Does the segment 0 <= t <= tmax meet the box the line enters at tn
    and leaves at tf?"""
    return (tf >= torch.clamp(tn, min=0.0)) & (tn <= tmax)


def _pair_keys(tab: Table, o, d, tmax, blk):
    """(P,) int64 key (t bits << 32 | triangle) of each (ray, block) pair's
    closest accepted triangle, _NONE where none is."""
    r = tab.rows[blk].unbind(1)  # 12 x (P, BLOCK)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ou = r[0] * ox + r[1] * oy + r[2] * oz + r[9]
    ov = r[3] * ox + r[4] * oy + r[5] * oz + r[10]
    ow = r[6] * ox + r[7] * oy + r[8] * oz + r[11]
    du = r[0] * dx + r[1] * dy + r[2] * dz
    dv = r[3] * dx + r[4] * dy + r[5] * dz
    dw = r[6] * dx + r[7] * dy + r[8] * dz
    flat = dw.abs() < EPSILON
    t = -ow / torch.where(flat, torch.ones_like(dw), dw)
    u = ou + t * du
    v = ov + t * dv
    ok = (~flat) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPSILON) & (t <= tmax[:, None])
    bits = t.float().contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(ok, (bits << 32) | tab.blocks[blk], _NONE)
    return key.amin(dim=1)


# a ray tests its candidate blocks nearest first, in rounds of these ranks;
# a block whose box it enters beyond its best hit so far is skipped
_ROUNDS = ((0, 1), (1, 2), (2, 3), (3, 4), (4, 6), (6, 8), (8, 12), (12, 16), (16, 24),
           (24, 32), (32, 64), (64, 1 << 40))


def closest_hit(tab: Table, o, d, tmax):
    """(t (M,) float32, +inf on a miss; triangle (M,) int64, 0 on a miss;
    hit (M,) bool) of rays o + t d against the table, t <= tmax (M,)."""
    m = o.shape[0]
    dev = o.device
    best = torch.full((m,), _NONE, dtype=torch.int64, device=dev)
    for r0 in range(0, m, ROW_CHUNK):
        rs = slice(r0, min(m, r0 + ROW_CHUNK))
        oc, dc, tc = o[rs], d[rs], tmax[rs]
        bc = best[rs]
        gm = _meets(*_slab(oc[:, None], dc[:, None], tab.glo, tab.ghi), tc[:, None]) & (tc > 0)[:, None]
        ri, gi = torch.nonzero(gm, as_tuple=True)
        bi = tab.groups[gi]  # (P, GROUP)
        rr = ri[:, None].expand_as(bi)
        keep = bi >= 0
        rr, bi = rr[keep], bi[keep]
        tn, tf = _slab(oc[rr], dc[rr], tab.lo[bi], tab.hi[bi])
        hit = _meets(tn, tf, tc[rr])
        rr, bi, tn = rr[hit], bi[hit], tn[hit]
        # each ray's candidates in ascending entry distance, and their rank
        order = torch.argsort(tn, stable=True)
        order = order[torch.argsort(rr[order], stable=True)]
        rr, bi, tn = rr[order], bi[order], tn[order]
        counts = torch.bincount(rr, minlength=oc.shape[0])
        rank = torch.arange(rr.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[rr]
        for lo, hi in _ROUNDS:
            t_best = (bc >> 32).to(torch.int32).view(torch.float32)
            t_best = torch.where(bc == _NONE, float("inf"), t_best)
            sel = (rank >= lo) & (rank < hi) & (tn.float() <= t_best[rr])
            pr, pb = rr[sel], bi[sel]
            for p0 in range(0, pr.numel(), PAIR_CHUNK):
                q = pr[p0:p0 + PAIR_CHUNK]
                key = _pair_keys(tab, oc[q], dc[q], tc[q], pb[p0:p0 + PAIR_CHUNK])
                bc.scatter_reduce_(0, q, key, reduce="amin")
    hit = best != _NONE
    t = (best >> 32).to(torch.int32).view(torch.float32)
    t = torch.where(hit, t, float("inf"))
    idx = torch.where(hit, best & 0xFFFFFFFF, 0)
    return t, idx, hit
