"""The plain reference render: a straightforward implementation of the
published raytracer's acoustic model (reuk/parallel-reverb-raytracer:
kernel.cpp, rayverb.cpp, filters.cpp), with the documented conventions of
the rayverb rebuild (hash-free chain identity here, whole-bin predelay
shift, the power-of-two histogram bound), that the program's impulse
responses are held to. It imports nothing of the program and takes nothing
it made: the scene comes from the OBJ and materials files
(``reference.scene``), the rays, positions and HRTF table are the
benchmark's inputs.

Per pair of source and mic, rays start at the source with unit volume in 8
bands and reflect specularly off the closest triangle:

  - the direct path: the source, if the mic sees it, arrives after |s - m|
    with air absorption exp(coefficient * distance) per band
  - every bounce emits a diffuse impulse towards the mic when the mic sees
    the bounce point: volume -v * specular * air(d) * diffuse * |n.d|, at
    the path length d = travelled + |mic - point|; the ray carries -v *
    specular on
  - the first NUM_IMAGE_SOURCE - 1 bounces also look for an image source:
    the mic mirrored through the chain of hit triangles (each mirrored
    through the ones before) gives the image; the path from the source to
    it must cross every mirrored triangle, each segment, unmirrored, must
    reach the scene exactly at its endpoint, and the mic must see the last
    point. An admitted image carries the pre-bounce volume times air
    absorption over the source-image distance. Chains are identified by
    their triangle indices (zero where a shorter chain was not admitted),
    and each chain counts once, with the record of the first ray that found
    it. Two rays can share a chain's identity and carry different images
    (their unadmitted prefixes differ), so the ray order is part of the
    result: ``render`` gives the response under each order of RAY_ORDERS,
    the published raytracer's (rays as generated) and the Morton order of
    the directions, and a program is held to the nearest
  - attenuation: per speaker (1 - c) + c * cos of the angle between the
    arrival and the speaker's direction; or per ear, 8-band gains from the
    HRTF table by azimuth and elevation in the head frame, and arrival time
    shifted by the ear's offset of 0.1 m
  - impulses bin at floor(t * sr + 0.5) into a histogram per channel and
    band; with trim_predelay the earliest arrival's bin moves to 0 (earlier
    bins sum into bin 0); the content ends after the last occupied bin
  - each band is filtered by the configuration's crossover (applied as its
    frequency response, in float64, direction by direction, the samples at
    and after the content zeroed after each pass), the bands are summed,
    the channels normalised together to a peak of 1, and with trim_tail
    cut after the last sample of magnitude 1e-5 or more

``dtype`` sets the arithmetic: float32, as the configurations state, or
bfloat16 for the lower-precision control (the filters then round each
pass's signal to bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry

EPSILON = geometry.EPSILON
NUM_BANDS = 8
NUM_IMAGE = 10
SECONDS_PER_METER = 1.0 / 340.0
AIR = np.array([0.001 * c for c in (-0.1, -0.2, -0.5, -1.1, -2.7, -9.4, -29.0, -60.0)],
               dtype=np.float32)
EAR_OFFSET = 0.1
TRIM_FLOOR = 1e-5
EDGES_UPPER = (175.0, 350.0, 700.0, 1400.0, 2800.0, 5600.0, 11200.0, 20000.0)
_DEGREES = np.float32(180.0 / np.pi)


def _norm(v):
    return torch.linalg.norm(v, dim=-1)


def _unit(v):
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(mag > 0, mag, torch.ones_like(mag))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _mirror(p, tri):
    """p reflected through the plane of the triangles tri (..., 3, 3)."""
    n = _unit(torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                                 tri[..., 2, :] - tri[..., 0, :], dim=-1))
    return p - n * (2.0 * torch.sum(n * (p - tri[..., 0, :]), dim=-1, keepdim=True))


def _triangle_t(o, d, tri):
    """Moller-Trumbore t of rays against single triangles, 0 where they
    miss or the triangle is degenerate (kernel.cpp:62-88)."""
    v0 = tri[..., 0, :]
    e0 = tri[..., 1, :] - v0
    e1 = tri[..., 2, :] - v0
    pvec = _cross(d, e1)
    det = _dot(e0, pvec)
    flat = det.abs() < EPSILON
    inv = 1.0 / torch.where(flat, torch.ones_like(det), det)
    tvec = o - v0
    u = inv * _dot(tvec, pvec)
    qvec = _cross(tvec, e0)
    v = inv * _dot(d, qvec)
    t = inv * _dot(e1, qvec)
    ok = (~flat) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return torch.where(ok, t, torch.zeros_like(t))


def _bound(mag):
    return mag * 1.001 + 0.01


class Scene:
    """A scene's arrays on the device in ``dtype``."""

    def __init__(self, tris: dict, dtype, device):
        self.dtype = dtype
        self.device = device
        f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)  # noqa: E731
        v0 = np.asarray(tris["v0"], np.float32)
        e0 = np.asarray(tris["v1"], np.float32) - v0
        e1 = np.asarray(tris["v2"], np.float32) - v0
        n = np.cross(e0, e1)
        mag = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(mag > 0, n / np.where(mag == 0, 1, mag), 0.0).astype(np.float32)
        self.verts = f(np.stack([v0, v0 + e0, v0 + e1], axis=1))
        self.normal = f(n)
        self.surface = torch.from_numpy(np.asarray(tris["surface"], np.int64)).to(device)
        self.specular = f(tris["specular"])
        self.diffuse = f(tris["diffuse"])
        self.bounds = np.asarray(tris["bounds"], np.float32)
        self.table = geometry.build_table(tris["v0"], tris["v1"], tris["v2"], dtype, device)
        self.air = f(AIR)

    def hit(self, o, d, tmax):
        t, idx, hit = geometry.closest_hit(self.table, o, d, tmax)
        return t.to(self.dtype), idx, hit


def trace(scene: Scene, mics, sources, pair, dirs, reflections: int, tick=None):
    """Trace rays; mics, sources (B, 3), pair (N,) int64, dirs (N, 3).
    Returns (diffuse rows: volume (R*N, 8), position (R*N, 3), time (R*N,),
    pair (R*N,); image records: volume (N, S, 8), position (N, S, 3), time
    (N, S), chain (N, S) int64)."""
    dt, dev = scene.dtype, scene.device
    n = dirs.shape[0]
    mic = mics[pair]
    src = sources[pair]
    air = lambda dist: torch.exp(dist[..., None] * scene.air)  # noqa: E731
    zero = torch.zeros((), dtype=dt, device=dev)

    # direct path, one row per pair
    diff0 = sources - mics
    dist0 = _norm(diff0)
    t0, _, h0 = scene.hit(sources, _unit(mics - sources), _bound(dist0))
    vis0 = (~h0) | (t0 > dist0)
    img_vol = [torch.where(vis0[:, None], air(dist0), zero)[pair]]
    img_pos = [torch.where(vis0[:, None], mics + diff0, zero)[pair]]
    img_time = [torch.where(vis0, SECONDS_PER_METER * dist0, zero)[pair]]
    img_idx = [torch.zeros((n,), dtype=torch.int64, device=dev)]

    pos = src.clone()
    d = dirs
    travelled = torch.zeros((n,), dtype=dt, device=dev)
    vol = torch.ones((n, NUM_BANDS), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    mic_image = mic
    chain = []
    rows = []
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    for bounce in range(reflections):
        if tick is not None:
            tick()
        live = torch.nonzero(alive).squeeze(1)
        t = torch.zeros((n,), dtype=dt, device=dev)
        tri = torch.zeros((n,), dtype=torch.int64, device=dev)
        got = torch.zeros((n,), dtype=torch.bool, device=dev)
        tl, il, hl = scene.hit(pos[live], d[live], inf.expand(live.numel()))
        t[live] = torch.where(hl, tl, zero)
        tri[live] = il
        got[live] = hl
        alive_new = alive & got
        point = pos + d * t[:, None]
        to_mic = _norm(mic - point)

        # can the mic see the bounce point? (origin at the mic)
        sd = _unit(point - mic)
        ts, _, hs = scene.hit(mic[live], sd[live], _bound(to_mic[live]))
        vis = torch.ones((n,), dtype=torch.bool, device=dev)
        vis[live] = (~hs) | (ts > to_mic[live] * (1.0 - 4e-6) - EPSILON)

        if bounce < NUM_IMAGE - 1:
            cur = scene.verts[tri]
            for plane in chain:
                cur = _mirror(cur, plane[..., None, :, :])
            chain.append(cur)
            mic_image_new = _mirror(mic_image, cur)
            k1 = bounce + 1
            img_dir = _unit(mic_image_new - src)
            tris = torch.stack(chain, dim=1)  # (N, k1, 3, 3)
            tk = _triangle_t(src[:, None, :], img_dir[:, None, :], tris)
            sel = torch.nonzero(alive_new & torch.all(tk > EPSILON, dim=-1)).squeeze(1)
            g = sel.numel()
            ok = torch.zeros((n,), dtype=torch.bool, device=dev)
            if g:
                s_src = src[sel][:, None, :]
                s_tk = tk[sel]
                s_tris = tris[sel]
                ip = s_src + img_dir[sel][:, None, :] * s_tk[..., None]
                world = []
                for k in range(k1):
                    p = ip[:, k]
                    for j in range(k - 1, -1, -1):
                        p = _mirror(p, s_tris[:, j])
                    world.append(p)
                world = torch.stack(world, dim=1)  # (g, k1, 3)
                start = torch.cat([s_src, world[:, :-1]], dim=1)
                seg = world - start
                seg_dir = _unit(seg)
                seg_len = _norm(seg)
                last = world[:, bounce]
                to_mic_img = mic[sel] - last
                mag_img = _norm(to_mic_img)
                tg, _, hg = scene.hit(start.reshape(-1, 3), seg_dir.reshape(-1, 3),
                                      _bound(seg_len).reshape(-1))
                tg = tg.reshape(g, k1)
                hg = hg.reshape(g, k1)
                reach = start + seg_dir * torch.where(hg, tg, zero)[..., None]
                seg_ok = (s_tk > EPSILON) & hg & torch.all((reach - world).abs() < EPSILON, dim=-1)
                tv, _, hv = scene.hit(last, _unit(to_mic_img), _bound(mag_img))
                ok[sel] = torch.all(seg_ok, dim=-1) & ((~hv) | (tv > mag_img))
            init = src - mic_image_new
            init_dist = _norm(init)
            img_vol.append(torch.where(ok[:, None], vol * air(init_dist), zero))
            img_pos.append(torch.where(ok[:, None], mic + init, zero))
            img_time.append(torch.where(ok, SECONDS_PER_METER * init_dist, zero))
            img_idx.append(torch.where(ok, tri + 1, 0))
            mic_image = mic_image_new

        # the diffuse impulse of this bounce, and the ray's next state
        surf = scene.surface[tri]
        new_vol = -vol * scene.specular[surf]
        nrm = scene.normal[tri]
        new_dist = travelled + t
        dist = torch.where(vis, new_dist + to_mic, zero)
        lambert = _dot(nrm, d).abs()
        out = new_vol * air(dist) * scene.diffuse[surf] * lambert[:, None]
        emit = alive_new & vis
        rows.append((torch.where(emit[:, None], out, zero),
                     torch.where(alive_new[:, None], point, zero),
                     torch.where(emit, SECONDS_PER_METER * dist, zero)))
        reflected = d - nrm * (2.0 * torch.sum(d * nrm, dim=-1, keepdim=True))
        a1 = alive_new[:, None]
        pos = torch.where(a1, point, pos)
        d = torch.where(a1, reflected, d)
        travelled = torch.where(alive_new, new_dist, travelled)
        vol = torch.where(a1, new_vol, vol)
        alive = alive_new

    while len(img_vol) < NUM_IMAGE:
        img_vol.append(torch.zeros((n, NUM_BANDS), dtype=dt, device=dev))
        img_pos.append(torch.zeros((n, 3), dtype=dt, device=dev))
        img_time.append(torch.zeros((n,), dtype=dt, device=dev))
        img_idx.append(torch.zeros((n,), dtype=torch.int64, device=dev))
    diffuse = (
        torch.cat([r[0] for r in rows]) if rows else torch.zeros((0, NUM_BANDS), dtype=dt, device=dev),
        torch.cat([r[1] for r in rows]) if rows else torch.zeros((0, 3), dtype=dt, device=dev),
        torch.cat([r[2] for r in rows]) if rows else torch.zeros((0,), dtype=dt, device=dev),
        pair.repeat(reflections),
    )
    images = (torch.stack(img_vol, 1), torch.stack(img_pos, 1), torch.stack(img_time, 1),
              torch.stack(img_idx, 1))
    return diffuse, images


def distinct_images(images, pair, remove_direct: bool, rank=None):
    """Flat rows (into N * S) of the admitted image records, one per
    distinct (pair, chain): of a chain's records, that of the ray first by
    ``rank`` (N,) (its place among its pair's rays; default the row)."""
    idx = images[3]
    n, s = idx.shape
    slot = torch.arange(s, device=idx.device)
    ok = (slot == 0) | (idx != 0)
    if remove_direct:
        ok = ok & (slot != 0)
    rows = torch.nonzero(ok.reshape(-1)).squeeze(1)
    if rows.numel() == 0:
        return rows
    r, k = rows // s, rows % s
    # the chain of slot k: its pair, its length and the indices of slots 1..k
    prefix = torch.where(slot[None, :] <= k[:, None], idx[r], 0)
    key = torch.cat([pair[r][:, None], k[:, None], prefix], dim=1)
    _, inverse = torch.unique(key, dim=0, return_inverse=True)
    by = rows if rank is None else rank[r] * s + k
    first = torch.full((int(inverse.max()) + 1,), n * s, dtype=torch.int64, device=idx.device)
    first.scatter_reduce_(0, inverse, by, reduce="amin")
    if rank is not None:
        # back from (rank, slot) to the row
        row_of = torch.empty_like(rank)
        row_of[rank] = torch.arange(n, device=idx.device)
        first = row_of[first // s] * s + first % s
    return torch.sort(first).values


def _head_basis(facing, up):
    x = _unit(torch.linalg.cross(up, facing, dim=-1))
    y = torch.linalg.cross(facing, x, dim=-1)
    return torch.stack([x, y, facing])


def _channel(model: dict, mic, pos, times, c: int):
    """(gain (M, 8) or (M, 1), time (M,)) of channel c."""
    if model["hrtf"]:
        basis = model["basis"]
        width = -EAR_OFFSET if c == 0 else EAR_OFFSET
        offset = torch.tensor([width, 0.0, 0.0], dtype=pos.dtype, device=pos.device)
        ear = basis @ offset + mic
        local = _unit(pos - mic) @ basis.T
        x, y, z = local[..., 0], local[..., 1], local[..., 2]
        az = torch.atan2(x, z) * _DEGREES
        a = torch.remainder(torch.floor(az + 180.0).to(torch.int64), 360)
        el = torch.atan2(y, torch.hypot(x, z)) * _DEGREES
        e = torch.clamp(90 - torch.trunc(el).to(torch.int64), 0, 179)
        gain = model["table"][c, a, e]
        shift = _norm(pos - ear) - _norm(pos - mic)
        return gain, times + shift * SECONDS_PER_METER
    cdir = model["dirs"][c]
    coeff = model["coeffs"][c]
    gain = (1.0 - coeff) + coeff * torch.sum(_unit(pos - mic) * _unit(cdir), dim=-1)
    return gain[:, None], times


def attenuation_model(doc: dict, hrtf_table, dtype, device) -> dict:
    """The attenuation of a configuration document: speakers or HRTF."""
    f = lambda x: torch.tensor(np.asarray(x, np.float32)).to(device=device, dtype=dtype)  # noqa: E731
    model = doc["attenuation_model"]
    if "hrtf" in model:
        def unit(v):
            v = np.asarray(v, np.float32)
            return (v / math.sqrt(float(np.dot(v, v)))).astype(np.float32)

        facing, up = f(unit(model["hrtf"]["facing"])), f(unit(model["hrtf"]["up"]))
        return {"hrtf": True, "channels": 2, "basis": _head_basis(facing, up),
                "table": f(hrtf_table)}
    spk = model["speakers"]
    return {"hrtf": False, "channels": len(spk),
            "dirs": f([s["direction"] for s in spk]),
            "coeffs": f([s["shape"] for s in spk])}


def _bin(model, mics, pair, vol, pos, times, hist, sr, tmin, tmax):
    """Add rows into hist (B, C, 8, L); update the per-pair time stats
    (min over t > 0, max) of the rows with any non-zero band."""
    nb, length = hist.shape[0], hist.shape[-1]
    nonzero = torch.any(vol != 0, dim=-1)
    mic = mics[pair]
    for c in range(model["channels"]):
        gain, tc = _channel(model, mic, pos, times, c)
        tc32 = tc.float()
        tmin.scatter_reduce_(0, pair, torch.where(nonzero & (tc32 > 0), tc32, float("inf")),
                             reduce="amin")
        tmax.scatter_reduce_(0, pair, torch.where(nonzero, tc32, 0.0), reduce="amax")
        idx = torch.floor(tc * np.float32(sr) + 0.5).to(torch.int64)
        keep = nonzero & (idx >= 0) & (idx < length)
        flat = torch.zeros((NUM_BANDS, nb * length), dtype=hist.dtype, device=hist.device)
        flat.index_add_(1, (pair * length + idx)[keep], (vol * gain)[keep].T)
        hist[:, c] += flat.reshape(NUM_BANDS, nb, length).permute(1, 0, 2)


def band_edges(lo: float, sr: float):
    edges = [float(lo)] + list(EDGES_UPPER)
    cap = 0.49 * float(sr)
    edges = [min(e, cap) for e in edges]
    for i in range(len(edges) - 1, 0, -1):
        if edges[i] <= edges[i - 1]:
            edges[i - 1] = edges[i] / 1.2
    return edges


def filter_passes(kind: str, sr: float, hipass: float):
    """[(coefficients (8, 5) b0 b1 b2 a1 a2, reversed)] of the crossover
    (filters.cpp:193-305): Linkwitz-Riley is a second-order Butterworth
    low-pass at each band's top edge run forward then backward, then the
    high-pass at its bottom edge backward and forward again; the one-pass
    biquad is the RBJ constant-skirt band-pass, forward."""
    edges = band_edges(hipass, sr)
    bands = [(edges[i], edges[i + 1]) for i in range(NUM_BANDS)]
    if kind == "onepass":
        rows = []
        for lo, hi in bands:
            c = math.sqrt(lo * hi)
            w = 2 * math.pi * c / sr
            q = math.sin(w) / (math.log(2) * math.log2(hi / lo) * w)
            alpha = math.sin(w) * math.sinh(1 / (2 * q))
            a0 = 1 + alpha
            rows.append((alpha / a0, 0.0, -alpha / a0, -2 * math.cos(w) / a0, (1 - alpha) / a0))
        return [(np.array(rows), False)]
    if kind != "linkwitz_riley":
        raise ValueError(f"the reference has no filter {kind!r}")

    def butter(f, high):
        c = math.cos(math.pi * f / sr) / math.sin(math.pi * f / sr)
        a0 = c * c + c * math.sqrt(2) + 1
        a1, a2 = -2 * (c * c - 1) / a0, (c * c - c * math.sqrt(2) + 1) / a0
        if high:
            return (c * c / a0, -2 * c * c / a0, c * c / a0, a1, a2)
        return (1 / a0, 2 / a0, 1 / a0, a1, a2)

    lp = np.array([butter(hi, False) for _, hi in bands])
    hp = np.array([butter(lo, True) for lo, _ in bands])
    return [(lp, False), (lp, True), (hp, False), (hp, True)]


def _filter(hist, content, passes, dtype):
    """hist (B, C, 8, L) -> (B, C, L) float64: every band through the passes
    (frequency responses on an FFT grid with room for the filters' tails),
    zeroed at and after the content after each pass, then summed."""
    length = hist.shape[-1]
    nfft = 1 << (2 * length + 16384 - 1).bit_length()
    k = torch.arange(nfft // 2 + 1, dtype=torch.float64, device=hist.device)
    z1 = torch.exp(-2j * math.pi * k / nfft)
    inside = torch.arange(length, device=hist.device)[None, None, None, :] < content[:, None, None, None]
    x = hist.to(torch.float64)
    for coeffs, rev in passes:
        c = torch.as_tensor(coeffs, dtype=torch.float64, device=hist.device)[:, :, None]
        resp = (c[:, 0] + c[:, 1] * z1 + c[:, 2] * z1 * z1) / (1 + c[:, 3] * z1 + c[:, 4] * z1 * z1)
        if rev:
            resp = resp.conj()
        x = torch.fft.irfft(torch.fft.rfft(x, n=nfft) * resp, n=nfft)[..., :length]
        x = torch.where(inside, x, 0.0)
        if dtype != torch.float32:
            x = x.to(dtype).to(torch.float64)
    return x.sum(dim=2)


# the orders in which rays claim an image chain: "given", as the published
# raytracer takes them (as generated); "morton", the stable Morton (Z-order)
# of the directions quantised to 10 bits per axis
RAY_ORDERS = ("given", "morton")


def ray_rank(order: str, dirs) -> np.ndarray:
    """(N,) the place of each of the directions (N, 3) float32 in ``order``."""
    n = dirs.shape[0]
    if order == "given":
        return np.arange(n)
    if order != "morton":
        raise ValueError(f"the reference has no ray order {order!r}")
    q = np.clip((dirs + 1.0) * 0.5 * 1023.0, 0, 1023).astype(np.uint32)
    rank = np.empty(n, np.int64)
    rank[np.argsort(geometry._morton(q), kind="stable")] = np.arange(n)
    return rank


def histogram_length(bounds, reflections: int, sr: float) -> int:
    diag = float(np.linalg.norm(np.asarray(bounds[1], np.float64) - bounds[0]))
    t = ((reflections + 2) * max(diag, 1.0) + 1.0) * SECONDS_PER_METER
    n = int(np.floor(t * sr + 0.5)) + 8
    return min(1 << (max(n, 256) - 1).bit_length(), 1 << 23)


def render(scene: Scene, doc: dict, sources, mics, dirs, hrtf_table=None, tick=None,
           orders=RAY_ORDERS):
    """Impulse responses of B pairs: sources, mics (B, 3) and dirs (B, N, 3)
    numpy float32; doc the configuration document. Returns, for each ray
    order of ``orders``, (B, C, L) float64 numpy, each pair's samples after
    its content zero, and with trim_tail (one pair only) cut as the
    configuration asks. ``tick`` is called once per bounce."""
    dt, dev = scene.dtype, scene.device
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device=dev, dtype=dt)  # noqa: E731
    dirs = np.asarray(dirs, np.float32)
    b, n = dirs.shape[:2]
    sr = float(doc["sample_rate"])
    refl = int(doc["reflections"])
    mics_t, srcs_t = f(mics), f(sources)
    pair = torch.arange(b, device=dev).repeat_interleave(n)
    model = attenuation_model(doc, hrtf_table, dt, dev)
    length = histogram_length(scene.bounds, refl, sr)
    mode = doc.get("output_mode", "all")
    diffuse, images = trace(scene, mics_t, srcs_t, pair, f(dirs.reshape(b * n, 3)), refl, tick)

    hist0 = torch.zeros((b, model["channels"], NUM_BANDS, length), dtype=dt, device=dev)
    tmin0 = torch.full((b,), float("inf"), device=dev)
    tmax0 = torch.zeros((b,), device=dev)
    if mode in ("all", "diffuse_only"):
        _bin(model, mics_t, diffuse[3], *diffuse[:3], hist0, sr, tmin0, tmax0)
    del diffuse
    outs = []
    for order in orders:
        hist, tmin, tmax = hist0.clone(), tmin0.clone(), tmax0.clone()
        if mode in ("all", "image_only"):
            rank = np.concatenate([p * n + ray_rank(order, dirs[p]) for p in range(b)])
            keep = distinct_images(images, pair, bool(doc.get("remove_direct", False)),
                                   torch.from_numpy(rank).to(dev))
            vol, pos, time_, _ = images
            _bin(model, mics_t, pair[keep // NUM_IMAGE], vol.reshape(-1, NUM_BANDS)[keep],
                 pos.reshape(-1, 3)[keep], time_.reshape(-1)[keep], hist, sr, tmin, tmax)
        outs.append(_finish(doc, hist, tmin, sr, dt))
    return outs


def _finish(doc: dict, hist, tmin, sr: float, dt):
    """The binned (B, C, 8, L) histogram to (B, C, L) responses: predelay
    trim, filters, normalisation, volume, tail trim."""
    b, length = hist.shape[0], hist.shape[-1]
    dev = hist.device
    positions = torch.arange(length, device=dev)
    if doc.get("trim_predelay", False):
        pre = torch.where(torch.isfinite(tmin), tmin, 0.0)
        shift = torch.floor(pre * np.float32(sr) + np.float32(0.5)).to(torch.int64)
        src = positions[None, :] + shift[:, None]  # (B, L)
        h = hist.reshape(b, -1, length)
        moved = torch.gather(h, 2, torch.clamp(src, 0, length - 1)[:, None, :].expand(h.shape))
        moved = torch.where(src[:, None, :] < length, moved, torch.zeros_like(moved))
        moved[..., 0] = torch.sum(torch.where(positions[None, None, :] <= shift[:, None, None], h,
                                              torch.zeros_like(h)), dim=-1)
        hist = moved.reshape(hist.shape)
    occupied = torch.any(torch.any(hist != 0, dim=2), dim=1)  # (B, L)
    content = torch.amax(torch.where(occupied, positions, -1), dim=-1) + 1
    kind = doc.get("filter", "onepass")
    mixed = _filter(hist, content, filter_passes(kind, sr, float(doc.get("hipass", 45.0))), dt)
    if doc.get("normalize", True):
        peak = mixed.abs().amax(dim=(1, 2), keepdim=True)
        mixed = mixed * torch.where(peak > 0, 1.0 / peak, torch.ones_like(peak))
    mixed = mixed * float(doc.get("volumme_scale", 1.0))
    if dt != torch.float32:
        mixed = mixed.to(dt).to(torch.float64)
    out = mixed.cpu().numpy()
    if doc.get("trim_tail", True):
        if b != 1:
            raise ValueError("trim_tail cuts one pair's response only")
        cnt = int(content[0])
        loud = (np.abs(out[0]) >= TRIM_FLOOR) & (np.arange(out.shape[-1]) < cnt)
        last = int(np.max(np.where(loud, np.arange(out.shape[-1]), -1)))
        out = out[:, :, :min(max(last, 0), cnt)]
    return out
