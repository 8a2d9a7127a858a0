"""The acoustic trace: specular bounce loop + image-source early reflections
(PyTorch counterpart of rayverb_tpu/ops/trace.py, ``_trace_impl`` :384-954).

Every geometric query (bounce hit, reversed mic shadow ray, image-source
path-validation segments, image mic visibility) is a batched closest-hit
sweep, so one kernel (intersect_cuda) carries the trace's arithmetic. Each
bounce runs exactly two sweeps: the bounce hit, then one combined sweep of
shadow rows (+ in the image phase, the validation segments and image
visibility rows of the rays that pass the admission gate). A trace of R
reflections therefore launches ``sweep_count(R) = 1 + 2R`` sweeps.

``trace`` runs the dense trace of a whole population (the modular
pipeline's): by default all rays in one pass, chunked only by a memory plan
(``trace_bytes``) or an explicit ``ray_chunk``.

Differences in form from the JAX trace, none in results:
  - the diffuse ``lax.scan`` is a Python loop
  - the eager image phase computes its validation geometry only for the
    rays that pass the exact ``seg_front`` admission gate (a dynamic-size
    gather), where the JAX trace keeps full-width rows and parks the rest
    dead; the rows left out could only ever produce ``img_ok = False``.
    The graphed image phase keeps fixed shapes as the JAX trace does, with
    the gated rays' rows first (a stable partition) and the rest parked
    dead
  - uint32 hashes are computed in int64 masked to 32 bits; the plain sort
    keys too (``_ray_sort_key``, ``_dir_morton``), which the trace sorts as
    int32 with the top bit flipped (``_signed32``; the same order); on the
    card each key is one launch of a CUDA kernel (ray_keys_cuda)
  - a multi-pair trace (``pair_id``, the batched datagen's) traces exactly
    B x N rows: the sweep takes any row count, so there is no padding of
    the rows to 512 (JAX datagen.py ``_ROW_ALIGN``) and no ``nvalid``; and
    the per-row mic and source are gathered once instead of riding the
    ray state through its re-sorts, since the state here never moves
Faithfully kept quirks of the reference are those listed in the JAX module
(sign flip per bounce, pre-bounce image volume, |n.d| Lambert term).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..constants import (
    AIR_COEFFICIENT,
    EPSILON,
    NUM_BANDS,
    NUM_IMAGE_SOURCE,
    SECONDS_PER_METER,
)
from ..utils import profiling
from .attenuate import _f32
from .intersect import (
    SWEEP_RAYS,
    Hit,
    TriangleSoup,
    closest_hit,
    intersect_triangle,
    runs_cuda,
    soup_from_scene,
)

# the JAX trace's rays per chunk (rayverb_tpu/ops/trace.py:56, the
# reference's RAY_GROUP_SIZE, rayverb.h:199); here a trace chunks at it only
# when asked to (trace's ray_chunk)
DEFAULT_RAY_CHUNK = 4096

# Origin far outside every block AABB: sweep rows parked here (with bound 0)
# take part in no triangle block.
_DEAD_ORIGIN = 3.0e8

_U32 = 0xFFFFFFFF


# kinds of sweep rows whose executed pair tests a trace counts (the JAX
# trace's sweep_stats keys, in sorted order): bounce hits, image mic
# visibility, image-path validation segments, reversed mic-shadow rows
SWEEP_KINDS = ("bounce", "imgvis", "seg", "shadow")
_BOUNCE, _IMGVIS, _SEG, _SHADOW = range(len(SWEEP_KINDS))


def sweep_count(nreflections: int) -> int:
    """Closest-hit sweeps one trace launches: the direct path, then two per
    bounce (bounce hit + shadow/validation sweep)."""
    return 1 + 2 * nreflections


def _spread9(x):
    """Spread the low 9 bits of an int64 (uint32 value) to every third bit."""
    x = x & 0x1FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread16(x):
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _quant9(x):
    """float32 in [0, 511] -> int64 (the JAX uint32 cast truncates)."""
    return torch.clamp(x, 0.0, 511.0).to(torch.int64)


def _dir_morton(d):
    """(N,) int64 holding a uint32: 27-bit Morton code of a unit direction
    mapped into the [0,1]^3 cube."""
    q = _quant9((d * 0.5 + 0.5) * 511.0)
    return (
        _spread9(q[:, 0])
        | (_spread9(q[:, 1]) << 1)
        | (_spread9(q[:, 2]) << 2)
    )


def _ray_sort_key(pos, direction, lo, inv_span):
    """(N,) int64 holding a uint32: the ``mix6`` key, a 1:1 interleave of
    the top 16 position-Morton and top 16 direction-Morton bits (position
    at the higher bit of each pair)."""
    q = _quant9((pos - lo) * inv_span * 511.0)
    m = (
        _spread9(q[:, 0])
        | (_spread9(q[:, 1]) << 1)
        | (_spread9(q[:, 2]) << 2)
    )
    dm = _dir_morton(direction)
    return ((_spread16(m >> 11) << 1) | _spread16(dm >> 11)) & _U32


def _signed32(key):
    """(N,) int32 of an (N,) int64 holding a uint32, in the same order: the
    key with its top bit flipped, read as signed (key - 2**31)."""
    return (key - 0x80000000).to(torch.int32)


def _bounce_key(pos, direction, lo, inv_span, impl: str):
    """(N,) int32: the mix6 key of _ray_sort_key, sorted as _signed32 of
    it. One kernel launch of ray_keys_cuda where runs_cuda says so, as for
    closest_hit; the counters sort_keys.fused and sort_keys.plain count the
    rows keyed each way."""
    n = pos.shape[0]
    if runs_cuda(pos, impl):
        from .ray_keys_cuda import bounce_key_cuda

        profiling.count("sort_keys.fused", n)
        return bounce_key_cuda(pos, direction, lo, inv_span)
    profiling.count("sort_keys.plain", n)
    return _signed32(_ray_sort_key(pos, direction, lo, inv_span))


def _shadow_key(d, alive, pair, impl: str):
    """The shadow rows' sort key: the direction key of the alive rows,
    0xFFFFFFFF on the dead ones (so they sort last), as _signed32 (N,)
    int32; with pair ids (N,) int64 (pair, key) in one int64, the dead rows
    under pair 0x7FFFFFFF. Dispatched and counted as _bounce_key."""
    n = d.shape[0]
    if runs_cuda(d, impl):
        from .ray_keys_cuda import shadow_key_cuda

        profiling.count("sort_keys.fused", n)
        return shadow_key_cuda(d, alive, pair)
    profiling.count("sort_keys.plain", n)
    key = torch.where(alive, _dir_morton(d), _U32)
    if pair is None:
        return _signed32(key)
    # (pair, key) in one int64: pairs below 2**31, keys below 2**32
    dead = torch.where(alive, pair, 0x7FFFFFFF)
    return (dead << 32) | key


class TraceOutputs(NamedTuple):
    """Dense per-ray trace results (rayverb_tpu/ops/trace.py:162-172)."""

    diffuse_volume: torch.Tensor    # (N, R, 8)
    diffuse_position: torch.Tensor  # (N, R, 3)
    diffuse_time: torch.Tensor      # (N, R)
    image_volume: torch.Tensor      # (N, NUM_IMAGE_SOURCE, 8)
    image_position: torch.Tensor    # (N, NUM_IMAGE_SOURCE, 3)
    image_time: torch.Tensor        # (N, NUM_IMAGE_SOURCE)
    image_index: torch.Tensor       # (N, NUM_IMAGE_SOURCE) int64, triangle+1


def _safe_normalize(v):
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(mag > 0, mag, 1.0)


def _tri_normal(tri):
    e0 = tri[..., 1, :] - tri[..., 0, :]
    e1 = tri[..., 2, :] - tri[..., 0, :]
    return _safe_normalize(torch.linalg.cross(e0, e1, dim=-1))


def _mirror_by(p, n, t0):
    """Reflect points (..., 3) through the plane of unit normal ``n`` that
    holds ``t0``."""
    return p - n * (2.0 * torch.sum(n * (p - t0), dim=-1, keepdim=True))


def _mirror_point(p, tri):
    """Reflect points (..., 3) through the plane of (..., 3, 3)
    (mirror_point, kernel.cpp:216-221)."""
    return _mirror_by(p, _tri_normal(tri), tri[..., 0, :])


def _mirror_tri(tri, plane):
    return _mirror_point(tri, plane[..., None, :, :])


def _mirror_through(p, normal, chain, filled=None):
    """Points ``p`` (N, ..., 3) reflected through the planes l = 0, 1, ...
    of ``chain`` (N, L, 3, 3) in turn, ``normal`` (N, L, 3) their
    _tri_normal (kernel.cpp:379-394); where ``filled`` (L,) bool is false,
    plane l leaves the points as they are."""
    for l in range(chain.shape[1]):
        m = _mirror_by(p, normal[:, l, None], chain[:, l, None, 0])
        p = m if filled is None else torch.where(filled[l], m, p)
    return p


def _segments(src, img_dir, t_k, normal, chain):
    """The validation segments of image paths from ``src`` (m, 3) along
    ``img_dir`` (m, 3), whose image-space hits on ``chain`` (m, c, 3, 3)
    (normals (m, c, 3)) are at ``t_k`` (m, c): (ip_world, prev_pts,
    seg_dir, seg_len), the hit points un-mirrored to world space, column j
    through planes j-1 .. 0 (kernel.cpp:412-414, all columns at once), and
    the segments that end at them."""
    ip = src[:, None, :] + img_dir[:, None, :] * t_k[..., None]
    c = ip.shape[1]
    for s in range(c - 1):
        planes = slice(0, c - 1 - s)  # pass s takes column j through plane j - 1 - s
        ip[:, s + 1 :] = _mirror_by(ip[:, s + 1 :], normal[:, planes], chain[:, planes, 0])
    prev = torch.cat([src[:, None, :], ip[:, :-1]], dim=1)
    vec = ip - prev
    return ip, prev, _safe_normalize(vec), torch.linalg.norm(vec, dim=-1)


def _segment_ok(prev_pts, seg_dir, ip_world, t_k, hit, t):
    """Validation (kernel.cpp:418-428): each segment's scene hit (``hit``,
    ``t``) lands on its endpoint, in front of the image source."""
    new_ip = prev_pts + seg_dir * torch.where(hit, t, 0.0)[..., None]
    return (t_k > EPSILON) & hit & torch.all(torch.abs(new_ip - ip_world) < EPSILON, dim=-1)


def _visible_from_hit(hit: Hit, mag):
    """point_intersection acceptance (kernel.cpp:295)."""
    return (~hit.hit) | (hit.t > mag)


def _inv_permutation(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _sweep_bound(mag):
    """Per-ray t_max of point-to-point sweeps (trace.py:286-301): hits
    beyond it cannot change a verdict."""
    return mag * 1.001 + 0.01


def _gather_hit(h: Hit, idx) -> Hit:
    return Hit(t=h.t[idx], index=h.index[idx], hit=h.hit[idx])


@functools.lru_cache(maxsize=16)
def _zhat(device) -> torch.Tensor:
    """+z on ``device``, made once per device: the direction of dead sweep
    rows (a copy from the host inside a bounce would not go into a bounce's
    CUDA graph)."""
    return torch.tensor([0.0, 0.0, 1.0], device=device)


def _shadow_rows(mic, intersection, alive, mag, pair=None, impl="auto"):
    """Reversed, direction-sorted mic-shadow sweep rows (trace.py:258-283):
    origin at the mic, direction toward the bounce point. Returns (origins,
    dirs, bounds, decide, inv_perm, mag_eff); gather the sweep's Hit through
    inv_perm before reading vis = (~hit) | (t > mag_eff).

    mic: (3,) or per-row (N, 3). pair (N,) int64 (multi-pair traces): the
    alive rows sort pair-major, then by direction, and the dead rows go
    last (JAX ``lexsort((key, dead))``), so a 32-ray group of the order
    kernel shares one mic origin. impl: the key's, as _shadow_key."""
    d = _safe_normalize(intersection - mic)
    perm = torch.argsort(_shadow_key(d, alive, pair, impl), stable=True)
    inv_perm = _inv_permutation(perm)
    mag_eff = mag * (1.0 - 4e-6) - EPSILON
    al1 = alive[:, None]
    origins = torch.where(al1, mic, _DEAD_ORIGIN)[perm]
    dirs = torch.where(al1, d, _zhat(d.device))[perm]
    bounds = torch.where(alive, _sweep_bound(mag), 0.0)[perm]
    decide = torch.where(alive, mag_eff, 0.0)[perm]
    return origins, dirs, bounds, decide, inv_perm, mag_eff


def _sorted_bounce_sweep(sweep, key, origins, dirs, t_max, kinds):
    """A bounce sweep of rows sorted by ``key`` (stable; a sweep-local
    permutation), its Hit back in row order. ``sweep`` is _trace_impl's."""
    perm = torch.argsort(key, stable=True)
    hs = sweep(origins[perm], dirs[perm], t_max[perm], kinds=kinds)
    return _gather_hit(hs, _inv_permutation(perm))


class _RayState(NamedTuple):
    pos: torch.Tensor       # (N, 3)
    dir: torch.Tensor       # (N, 3)
    distance: torch.Tensor  # (N,)
    volume: torch.Tensor    # (N, 8)
    alive: torch.Tensor     # (N,) bool


# slots of the image chain: the triangles of phase A's bounces
_SLOTS = NUM_IMAGE_SOURCE - 1


class _ImageState(NamedTuple):
    """Phase A's state at fixed shapes (the graphed image bounce): the ray
    state, then the image chain held in _SLOTS slots, of which the first
    ``index`` are filled."""

    pos: torch.Tensor             # (N, 3)
    dir: torch.Tensor             # (N, 3)
    distance: torch.Tensor        # (N,)
    volume: torch.Tensor          # (N, 8)
    alive: torch.Tensor           # (N,) bool
    chain: torch.Tensor           # (N, _SLOTS, 3, 3) image-space triangles
    normal: torch.Tensor          # (N, _SLOTS, 3) their _tri_normal
    mic_reflection: torch.Tensor  # (N, 3) the mic mirrored through the chain
    index: torch.Tensor           # (1,) int64: the bounce, the filled slots


def _graph_engages(dev, impl: str, diffuse_bounces: int) -> bool:
    """Whether phase B's bounces run by replay of one CUDA graph
    (_BounceGraph): CUDA tensors swept by the kernel and at least two pure
    diffuse bounces. Everything else runs the eager loop, with the same
    results."""
    return dev.type == "cuda" and impl in ("auto", "cuda") and diffuse_bounces >= 2


# Rows (rays x pairs) of a trace at or under which phase A's image bounces
# run by replay of one CUDA graph (_image_graph_engages). The graphed bounce
# keeps fixed shapes, so its elementwise work is _SLOTS rows wide per ray
# however few rays pass the image gate; the eager bounce does that work on
# the gated rays alone, but the host waits for the card at its gate. On an
# H100 80GB HBM3 (700 W), chip_smoke.py's phase image_graph_rows (the
# vault's phase A, capture included, synced, graphed / eager, median of 3,
# ms): 24.5 / 27.9 at 50,000 rows, 33.2 / 34.2 at 100,000, 53.1 / 44.7 at
# 196,608, 71.0 / 53.5 at 262,144, 95.0 / 62.5 at 393,216, 218.7 / 126.2 at
# 1,000,000; the datagen cell's whole 262,144-row batch 151.9 / 132.8.
# Whole renders gain more than phase A's wall shows, the host running
# ahead of the card: Stonehenge's 100,000 rays 0.116 against 0.131 s an
# IR, the datagen cell 395-413 against 448-458 pairs/s. So the bound is
# the largest size measured cheaper both ways.
IMAGE_GRAPH_ROWS = 100_000


def _image_graph_engages(dev, impl: str, rows: int, image_bounces: int) -> bool:
    """Whether phase A's image bounces run by replay of one CUDA graph of
    the fixed-shape image bounce: on the rule of _graph_engages, and at or
    under IMAGE_GRAPH_ROWS rows. Everything else runs the eager bounce,
    whose gate compacts the rays, with the same results."""
    return _graph_engages(dev, impl, image_bounces) and rows <= IMAGE_GRAPH_ROWS


# device -> (the side stream phase B's graphs are captured on, a graph
# that holds their memory pool open), made once per device (_graph_home)
_graph_homes: dict = {}


def _graph_home(dev):
    """(capture stream, pool keeper) of ``dev``. A graph's memory pool
    stays open while some graph holds it, and a pool whose graphs are all
    gone cannot be captured into again; the keeper, a one-node graph
    captured into the pool and never replayed, holds it. So each trace's
    graph reuses the pool's blocks that the last one freed, and the one
    stream's merge scratch (intersect_cuda._scratch)."""
    home = _graph_homes.get(dev)
    if home is None:
        stream = torch.cuda.Stream(dev)
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            keeper.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=dev)
            keeper.capture_end()
        home = _graph_homes[dev] = (stream, keeper)
    return home


class _BounceGraph:
    """A bounce, ``body`` (state -> (next state, row)), captured once as a
    CUDA graph over static buffers and replayed once per bounce: phase B's
    diffuse bounce, and phase A's fixed-shape image bounce. The static
    state (a NamedTuple of tensors) starts as a copy of ``state``; each
    replay runs the same kernels in the same order on it as the eager loop,
    copies the next state back into it, so the replays chain, and leaves
    the bounce's row in ``row``, which the next replay overwrites.
    ``rows``: the rows of the body's largest sweep (None: the state's).

    The capture enqueues nothing: the first step is the captured bounce's
    own replay. The host counters that the capture added (the call's
    closest_hit.calls and .rows, the kernels' launch counters) stand for
    that first replay and are added again at each later one; the device
    counters (the sweeps' pair_sums) are added by the replayed launches."""

    def __init__(self, body, state, rows: int | None = None):
        self.body = body
        self.state = type(state)(*(x.clone() for x in state))
        self.rows = state.pos.shape[0] if rows is None else rows
        self.row = None
        before = profiling.host_counts()
        self._capture()
        after = profiling.host_counts()
        self.counts = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
        self.replays = 0

    def chain(self):
        """One bounce of the static state, the next state copied back into
        it; returns the row."""
        nxt, row = self.body(self.state)
        for buf, x in zip(self.state, nxt):
            buf.copy_(x)
        return row

    def _capture(self):
        from .intersect_cuda import _scratch

        dev = self.state.pos.device
        stream, keeper = _graph_home(dev)
        # the sweeps' merge scratch of the capture stream, made now: made
        # inside the capture it would land in the graph's pool; and the dead
        # rows' direction, whose copy from the host cannot be captured
        _scratch(dev, stream.cuda_stream, self.rows)
        _zhat(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=keeper.pool(), capture_error_mode="thread_local")
            try:
                self.row = self.chain()
            except BaseException:
                # end the broken capture; the body's error is the one to see
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()

    def _replay(self):
        self.graph.replay()

    def step(self):
        """Run the next bounce; returns its row (volume (N, 8), position
        (N, 3), time (N,)), valid until the next step."""
        if self.replays:
            profiling.add_counts(self.counts)
        self._replay()
        self.replays += 1
        return self.row


def _trace_impl(
    soup: TriangleSoup,
    mic,
    source,
    directions,
    *,
    nreflections: int,
    impl: str = "auto",
    consume_row=None,
    resort: bool = False,
    stats: torch.Tensor | None = None,
    pair_id=None,
    bounce_graph: bool = True,
):
    """The trace loop. With ``consume_row=None`` returns TraceOutputs (dense
    per-ray rows). Otherwise each diffuse row (volume (N,8), position (N,3),
    time (N,)) is handed to ``consume_row`` as it is produced and the call
    returns the image slots (vol, pos, time, index), each (N, S, ...).

    pair_id ((N,) int64, consume path only) puts the trace in multi-pair
    mode (JAX trace.py:409-418), the batched datagen's: ``mic`` and
    ``source`` are (B, 3) per-pair arrays and row i belongs to pair
    pair_id[i]. Every sweep carries all B pairs' rows at once; the direct
    path is one B-row sweep gathered back onto the rows. The per-row mic
    and source are gathered once: the ray state stays in row order (only
    a sweep permutes its rows), so they never move. Consumed rows then
    carry (mic_rows (N, 3), pair_id (N,)) after (volume, position, time),
    and the image slots line up with the rows.

    resort=True feeds each later bounce sweep its rows sorted by the mix6
    key (a sweep-local permutation; the ray state stays in row order).

    stats, a (2 * len(SWEEP_KINDS),) int64 tensor on the soup's device
    (profiling.pair_sums): every sweep but the direct path's adds its
    executed pair tests by row kind, and then its live rows (t_max > 0) by
    row kind, into it in place, in the sweep's own launch (JAX
    trace.py:492-523). Each image-phase sweep holds shadow rows, then
    segment rows, then image-visibility rows; its counts are split at
    those row ranges exactly. With stats=None the sweeps run
    without counters.

    Phase B (the pure diffuse bounces after the image phase) runs by
    replay of one CUDA graph of its bounce (_BounceGraph) where
    _graph_engages says so and ``bounce_graph`` is true (False: the eager
    loops, for tests), with the same kernels on the same data, so the same
    results. Phase A's image bounces run by replay of a graph of the
    fixed-shape image bounce (bounce 0 among them, its rows unsorted as
    in the eager loop) where _image_graph_engages says so (at most IMAGE_GRAPH_ROWS rows) and
    ``bounce_graph`` is true; every live element takes the eager bounce's
    float32 operations, so the same results. The graphs and their buffers
    go when the call ends. Dense rows and image slots are then copied out
    of the graph's row buffers; a consumer reads each row before the next
    bounce overwrites it.

    The two phases are the stage spans rv.phase_a (the direct path and
    the min(R, 9) image bounces) and rv.phase_b (the pure diffuse bounces),
    each holding its graph's capture and replays, each ended by a device
    synchronisation in a stats call (profiling.phase), so that the device
    trace tells their idle gaps apart. Each bounce inside them is the span
    rv.bounce (attrs index, phase 'image' or 'diffuse', graph); a capture
    is the span rv.graph_capture; the eager image gate's compaction, where
    the host waits for the device, is the span rv.sync (site
    'image_gate'). The counters bounces.graph and bounces.eager count the
    call's bounces by how they ran, bounces.image_graph phase A's replays,
    sort_keys.fused and sort_keys.plain the rows of its sort keys by how
    they were computed (_bounce_key, _shadow_key: by ``impl``)."""
    dev = soup.device
    mic = _f32(mic, dev)
    source = _f32(source, dev)
    directions = _f32(directions, dev)
    n = directions.shape[0]
    multi = pair_id is not None
    if multi:
        if consume_row is None:
            raise ValueError("a multi-pair trace needs consume_row")
        pair_id = torch.as_tensor(pair_id, device=dev).to(torch.int64)
        mic_rows = mic[pair_id]
        src_rows = source[pair_id]
    else:
        mic_rows = mic.expand(n, 3)
        src_rows = source.expand(n, 3)
    air = torch.from_numpy(AIR_COEFFICIENT).to(dev)
    if resort:
        lo_b = soup.bounds[0]
        inv_span = 1.0 / torch.clamp(soup.bounds[1] - soup.bounds[0], min=1e-6)

    def air_attenuation(distance):
        return torch.exp(distance[..., None] * air)

    def sweep(origins, dirs, t_max, t_decide=None, kinds=()):
        """closest_hit; with stats, executed pairs of the rows [start, end)
        of each (kind, start, end) of ``kinds`` go to stats[kind]."""
        return closest_hit(
            origins, dirs, soup, impl=impl, t_max=t_max, t_decide=t_decide,
            pair_sums=stats if kinds else None, kinds=kinds,
        )

    def sorted_bounce_hit(pos, dirv, alive, do_sort):
        """The bounce sweep; with resort its rows sorted by the mix6 key
        where ``do_sort`` holds: a bool, or a (1,) bool tensor (the graphed
        image bounce's), where false keeps the rows in their order by
        taking the row index for the key."""
        o = torch.where(alive[:, None], pos, _DEAD_ORIGIN)
        b = torch.where(alive, float("inf"), 0.0)
        kinds = ((_BOUNCE, 0, n),)
        if not resort or do_sort is False:
            return sweep(o, dirv, b, kinds=kinds)
        key = _bounce_key(pos, dirv, lo_b, inv_span, impl)
        if do_sort is not True:
            key = torch.where(do_sort, key, torch.arange(n, dtype=key.dtype, device=dev))
        return _sorted_bounce_sweep(sweep, key, o, dirv, b, kinds)

    def bounce_hit(state, do_sort):
        """The bounce sweep of ``state``'s rays: (Hit, t_safe, the rays
        alive after it, the hit points)."""
        hit = sorted_bounce_hit(state.pos, state.dir, state.alive, do_sort)
        t_safe = torch.where(hit.hit, hit.t, 0.0)
        return hit, t_safe, state.alive & hit.hit, state.pos + state.dir * t_safe[:, None]

    def diffuse_impulse(state, hit, vis, t_safe):
        """Per-bounce diffuse Impulse fields (kernel.cpp:459-501)."""
        alive_new = state.alive & hit.hit
        intersection = state.pos + state.dir * t_safe[:, None]
        new_dist = state.distance + t_safe
        surf = soup.surface[hit.index]
        new_vol = -state.volume * soup.specular[surf]
        nrm = soup.normal[hit.index]
        to_mic_dist = torch.linalg.norm(mic_rows - intersection, dim=-1)
        dist = torch.where(vis, new_dist + to_mic_dist, 0.0)
        diff = torch.abs(torch.sum(nrm * state.dir, dim=-1))
        volume_out = (
            new_vol * air_attenuation(dist) * soup.diffuse[surf] * diff[:, None]
        )
        emit = alive_new & vis
        volume_out = torch.where(emit[:, None], volume_out, 0.0)
        position_out = torch.where(alive_new[:, None], intersection, 0.0)
        time_out = torch.where(emit, SECONDS_PER_METER * dist, 0.0)
        new_dir = state.dir - nrm * (
            2.0 * torch.sum(state.dir * nrm, dim=-1, keepdim=True)
        )
        a1 = alive_new[:, None]
        next_state = _RayState(
            pos=torch.where(a1, intersection, state.pos),
            dir=torch.where(a1, new_dir, state.dir),
            distance=torch.where(alive_new, new_dist, state.distance),
            volume=torch.where(a1, new_vol, state.volume),
            alive=alive_new,
        )
        return next_state, (volume_out, position_out, time_out)

    def diffuse_bounce(state):
        """One bounce of phase B: (next state, row)."""
        bounce, t_safe, alive2, intersection = bounce_hit(state, True)
        mag = torch.linalg.norm(mic_rows - intersection, dim=-1)
        sh_origin, sh_d, sh_bound, sh_decide, sh_inv, sh_mag_eff = _shadow_rows(
            mic_rows, intersection, alive2, mag, pair_id, impl
        )
        shadow = sweep(sh_origin, sh_d, sh_bound, sh_decide, kinds=((_SHADOW, 0, n),))
        vis = _visible_from_hit(_gather_hit(shadow, sh_inv), sh_mag_eff)
        return diffuse_impulse(state, bounce, vis, t_safe)

    def image_gate(alive_new, mic_reflection, chain, upto=None):
        """The exact admission gate (kernel.cpp:396-429): emitting a
        bounce's image needs every segment's mirrored-space hit on
        ``chain`` in front (of its slots where ``upto`` holds). Returns
        (img_dir, t_k, gated)."""
        img_dir = _safe_normalize(mic_reflection - src_rows)
        t_k = intersect_triangle(src_rows[:, None, :], img_dir[:, None, :], chain)
        front = t_k > EPSILON
        return img_dir, t_k, alive_new & torch.all(front if upto is None else front | ~upto, dim=-1)

    def image_sweep(shadow, seg, img):
        """One sweep of a bounce's shadow rows (_shadow_rows' six), then
        its validation segment rows (origins, dirs, bounds) and image
        visibility rows (origins, dirs, bounds, decide); only the segments
        need the exact closest hit. Returns (the shadow rows' vis in row
        order, the segment rows' Hit, the visibility rows' Hit)."""
        m_seg = seg[0].shape[0]
        s_end = n + m_seg
        hits = sweep(
            torch.cat([shadow[0], seg[0], img[0]]),
            torch.cat([shadow[1], seg[1], img[1]]),
            torch.cat([shadow[2], seg[2], img[2]]),
            torch.cat([shadow[3], torch.zeros((m_seg,), device=dev), img[3]]),
            kinds=((_SHADOW, 0, n), (_SEG, n, s_end), (_IMGVIS, s_end, s_end + img[0].shape[0])),
        )
        vis = _visible_from_hit(_gather_hit(_gather_hit(hits, slice(0, n)), shadow[4]), shadow[5])
        return vis, _gather_hit(hits, slice(n, s_end)), _gather_hit(hits, slice(s_end, None))

    def image_outputs(volume, mic_reflection, img_ok, index):
        """The image slot of a bounce: the image impulse carries the
        PRE-bounce volume (kernel.cpp:442-455)."""
        init_diff = src_rows - mic_reflection
        init_dist = torch.linalg.norm(init_diff, dim=-1)
        ok1 = img_ok[:, None]
        return (
            torch.where(ok1, volume * air_attenuation(init_dist), 0.0),
            torch.where(ok1, mic_rows + init_diff, 0.0),
            torch.where(img_ok, SECONDS_PER_METER * init_dist, 0.0),
            torch.where(img_ok, index + 1, 0),
        )

    def image_bounce(state: _ImageState):
        """One bounce of phase A at fixed shapes, for its graph: (next
        state, diffuse row + image slot). Every live element goes through
        the eager bounce's float32 operations in its order, and bounce 0's
        rows keep their order, as in the eager loop. The chain's slots
        past ``index`` are masked where the eager bounce has no column;
        the image gate is a stable partition on the card (the gated rays
        first, in row order), and the gated rays' segment and visibility
        rows lead fixed regions of the combined sweep, the other rows
        parked dead (bound 0)."""
        ray = _RayState(*state[:5])
        bounce, t_safe, alive_new, intersection = bounce_hit(ray, state.index > 0)

        # the hit triangle mirrored through the chain's filled slots
        slot = torch.arange(_SLOTS, device=dev)
        upto = slot <= state.index  # the chain after this bounce
        cur = _mirror_through(soup.verts(bounce.index), state.normal[:, :-1],
                              state.chain[:, :-1], slot[:-1] < state.index)
        nrm = _tri_normal(cur)
        at = slot == state.index
        chain = torch.where(at[:, None, None], cur[:, None], state.chain)
        normal = torch.where(at[:, None], nrm[:, None], state.normal)
        mic_reflection = _mirror_by(state.mic_reflection, nrm, cur[:, 0])
        img_dir, t_k, maybe = image_gate(alive_new, mic_reflection, chain, upto)
        # stable partition: rank of each ray, the g gated rays first
        count = torch.cumsum(maybe, 0)
        g = count[-1:]
        rank = torch.where(maybe, count - 1, g + torch.arange(n, device=dev) - count)
        perm = _inv_permutation(rank)

        ip_world, prev_pts, seg_dir, seg_len = _segments(src_rows, img_dir, t_k, normal, chain)
        final_ip = torch.index_select(ip_world, 1, state.index)[:, 0]
        to_mic_image = mic_rows - final_ip
        mag_image = torch.linalg.norm(to_mic_image, dim=-1)

        # segment region (_SLOTS x n rows): gated ray i's segment j at row
        # i * k1 + j; image-visibility region (n rows): gated ray i at i
        k1 = state.index + 1
        q = torch.arange(_SLOTS * n, device=dev)
        i = q // k1
        seg_live = i < g
        src = perm[torch.clamp(i, max=n - 1)] * _SLOTS + (q - i * k1)
        vis_live = torch.arange(n, device=dev) < g
        zhat = _zhat(dev)
        sl1, vl1 = seg_live[:, None], vis_live[:, None]
        vis, seg, img = image_sweep(
            _shadow_rows(mic_rows, intersection, alive_new,
                         torch.linalg.norm(mic_rows - intersection, dim=-1), pair_id, impl),
            (torch.where(sl1, prev_pts.view(-1, 3)[src], _DEAD_ORIGIN),
             torch.where(sl1, seg_dir.view(-1, 3)[src], zhat),
             torch.where(seg_live, _sweep_bound(seg_len).view(-1)[src], 0.0)),
            (torch.where(vl1, final_ip[perm], _DEAD_ORIGIN),
             torch.where(vl1, _safe_normalize(to_mic_image)[perm], zhat),
             torch.where(vis_live, _sweep_bound(mag_image)[perm], 0.0),
             torch.where(vis_live, mag_image[perm], 0.0)),
        )
        seg_at = torch.clamp(rank[:, None] * k1 + slot, max=_SLOTS * n - 1)
        seg_ok = _segment_ok(prev_pts, seg_dir, ip_world, t_k, seg.hit[seg_at], seg.t[seg_at])
        img_ok = (maybe & torch.all(seg_ok | ~upto, dim=-1)
                  & _visible_from_hit(_gather_hit(img, rank), mag_image))

        image = image_outputs(ray.volume, mic_reflection, img_ok, bounce.index)
        nxt, row = diffuse_impulse(ray, bounce, vis, t_safe)
        return (
            _ImageState(*nxt, chain, normal, mic_reflection, state.index + 1),
            row + image,
        )

    state = _RayState(
        pos=src_rows.clone(),
        dir=directions,
        distance=torch.zeros((n,), device=dev),
        volume=torch.ones((n, NUM_BANDS), device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )

    with profiling.phase("rv.phase_a"):
        # ---- direct path (image slot 0), identical for every ray of a pair:
        # one row per pair (one B-row sweep in multi-pair mode) ----
        mic2 = mic.reshape(-1, 3)
        src2 = source.reshape(-1, 3)
        diff0 = src2 - mic2
        dist0 = torch.linalg.norm(diff0, dim=-1)
        h0 = sweep(src2, _safe_normalize(mic2 - src2), _sweep_bound(dist0))
        vis0 = _visible_from_hit(h0, dist0)
        vol0 = torch.where(vis0[:, None], air_attenuation(dist0), 0.0)
        pos0 = torch.where(vis0[:, None], mic2 + diff0, 0.0)
        time0 = torch.where(vis0, SECONDS_PER_METER * dist0, 0.0)
        if multi:
            image_vol, image_pos, image_time = [vol0[pair_id]], [pos0[pair_id]], [time0[pair_id]]
        else:
            image_vol = [vol0.expand(n, NUM_BANDS)]
            image_pos = [pos0.expand(n, 3)]
            image_time = [time0.expand(n)]
        image_idx = [torch.zeros((n,), dtype=torch.int64, device=dev)]

        image_slots = (image_vol, image_pos, image_time, image_idx)
        diffuse_rows = []
        # multi-pair rows carry their mic and pair to the consumer
        extra = (mic_rows, pair_id) if multi else ()

        def emit_row(row, graphed):
            if consume_row is not None:
                consume_row(row + extra)
            elif graphed:
                # a replay overwrites its row: the dense rows keep copies
                diffuse_rows.append(tuple(x.clone() for x in row))
            else:
                diffuse_rows.append(row)

        # ---- phase A: bounces that take part in the image-source search, by
        # replay of one CUDA graph of the fixed-shape image bounce where it
        # engages (_image_graph_engages), else eagerly ----
        n_image_bounces = min(nreflections, _SLOTS)
        image_graphed = bounce_graph and _image_graph_engages(dev, impl, n, n_image_bounces)
        if image_graphed:
            graph = None
            for index in range(n_image_bounces):
                with profiling.span("rv.bounce", index=index, phase="image", graph=True):
                    if graph is None:
                        with profiling.span("rv.graph_capture"):
                            graph = _BounceGraph(image_bounce, _ImageState(
                                *state,
                                chain=torch.zeros((n, _SLOTS, 3, 3), device=dev),
                                normal=torch.zeros((n, _SLOTS, 3), device=dev),
                                mic_reflection=mic_rows,
                                index=torch.zeros((1,), dtype=torch.int64, device=dev),
                            ), rows=(_SLOTS + 2) * n)
                    row = graph.step()
                    for slots, x in zip(image_slots, row[3:]):
                        slots.append(x.clone())
                    emit_row(row[:3], True)
            state = _RayState(*graph.state[:5])
            del graph
        else:
            mic_reflection = mic_rows
            chain = torch.zeros((n, 0, 3, 3), device=dev)
            normal = torch.zeros((n, 0, 3), device=dev)
            for index in range(n_image_bounces):
                with profiling.span("rv.bounce", index=index, phase="image", graph=False):
                    bounce, t_safe, alive_new, intersection = bounce_hit(state, index > 0)
                    # the hit triangle mirrored through the chain
                    cur = _mirror_through(soup.verts(bounce.index), normal, chain)
                    nrm = _tri_normal(cur)
                    chain = torch.cat([chain, cur[:, None]], dim=1)  # (N, k+1, 3, 3)
                    normal = torch.cat([normal, nrm[:, None]], dim=1)
                    mic_reflection = _mirror_by(mic_reflection, nrm, cur[:, 0])
                    img_dir, t_k, maybe = image_gate(alive_new, mic_reflection, chain)
                    with profiling.span("rv.sync", site="image_gate"):
                        sel = torch.nonzero(maybe).squeeze(1)  # gated rays, in order
                    g = sel.shape[0]
                    k1 = index + 1

                    # validation geometry for the gated rays only
                    t_k_s = t_k[sel]
                    ip_world_s, prev_pts_s, seg_dir_s, seg_len_s = _segments(
                        src_rows[sel], img_dir[sel], t_k_s, normal[sel], chain[sel]
                    )
                    final_ip_s = ip_world_s[:, index]
                    to_mic_image_s = mic_rows[sel] - final_ip_s
                    mag_image_s = torch.linalg.norm(to_mic_image_s, dim=-1)
                    vis, seg, img = image_sweep(
                        _shadow_rows(mic_rows, intersection, alive_new,
                                     torch.linalg.norm(mic_rows - intersection, dim=-1),
                                     pair_id, impl),
                        (prev_pts_s.reshape(g * k1, 3), seg_dir_s.reshape(g * k1, 3),
                         _sweep_bound(seg_len_s).reshape(g * k1)),
                        (final_ip_s, _safe_normalize(to_mic_image_s), _sweep_bound(mag_image_s),
                         mag_image_s),
                    )
                    seg_ok_s = _segment_ok(prev_pts_s, seg_dir_s, ip_world_s, t_k_s,
                                           seg.hit.reshape(g, k1), seg.t.reshape(g, k1))
                    img_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
                    img_ok[sel] = torch.all(seg_ok_s, dim=-1) & _visible_from_hit(img, mag_image_s)

                    image = image_outputs(state.volume, mic_reflection, img_ok, bounce.index)
                    for slots, x in zip(image_slots, image):
                        slots.append(x)
                    state, row = diffuse_impulse(state, bounce, vis, t_safe)
                    emit_row(row, False)

    with profiling.phase("rv.phase_b"):
        # ---- phase B: pure diffuse bounces, by replay of one CUDA graph of
        # the bounce where it engages (_graph_engages), else eagerly ----
        diffuse = range(n_image_bounces, nreflections)
        graphed = bounce_graph and _graph_engages(dev, impl, len(diffuse))
        graph = None
        for index in diffuse:
            with profiling.span("rv.bounce", index=index, phase="diffuse", graph=graphed):
                if not graphed:
                    state, row = diffuse_bounce(state)
                else:
                    if graph is None:
                        with profiling.span("rv.graph_capture"):
                            graph = _BounceGraph(diffuse_bounce, state)
                    row = graph.step()
                emit_row(row, graphed)
        del graph
    image_replayed = n_image_bounces if image_graphed else 0
    replayed = image_replayed + (len(diffuse) if graphed else 0)
    profiling.count("bounces.graph", replayed)
    profiling.count("bounces.image_graph", image_replayed)
    profiling.count("bounces.eager", nreflections - replayed)

    # pad image slots when nreflections < NUM_IMAGE_SOURCE - 1
    while len(image_vol) < NUM_IMAGE_SOURCE:
        image_vol.append(torch.zeros((n, NUM_BANDS), device=dev))
        image_pos.append(torch.zeros((n, 3), device=dev))
        image_time.append(torch.zeros((n,), device=dev))
        image_idx.append(torch.zeros((n,), dtype=torch.int64, device=dev))

    images = (
        torch.stack(image_vol, dim=1),
        torch.stack(image_pos, dim=1),
        torch.stack(image_time, dim=1),
        torch.stack(image_idx, dim=1),
    )
    if consume_row is not None:
        return images

    def stack(i, width):
        if not diffuse_rows:
            return torch.zeros((n, 0) + width, device=dev)
        return torch.stack([r[i] for r in diffuse_rows], dim=1)

    return TraceOutputs(
        diffuse_volume=stack(0, (NUM_BANDS,)),
        diffuse_position=stack(1, (3,)),
        diffuse_time=stack(2, ()),
        image_volume=images[0],
        image_position=images[1],
        image_time=images[2],
        image_index=images[3],
    )


def trace_chunk(
    soup: TriangleSoup,
    mic,
    source,
    directions,
    *,
    nreflections: int,
    impl: str = "auto",
    resort: bool = False,
) -> TraceOutputs:
    """Trace all rays end to end and return the dense per-ray records
    (the counterpart of rayverb_tpu.ops.trace.trace_chunk)."""
    return _trace_impl(
        soup,
        mic,
        source,
        directions,
        nreflections=nreflections,
        impl=impl,
        resort=resort,
    )


def trace_bytes(nrays: int, nreflections: int, nblocks: int) -> int:
    """Planned peak device bytes of one chunk of ``nrays`` rays through the
    dense trace, over a table of ``nblocks`` blocks, from the shapes:

      - the dense outputs, twice (the per-bounce rows and their stacked
        copy): nrays x R diffuse rows of (8 + 3 + 1) float32, and nrays x
        NUM_IMAGE_SOURCE image slots of (8 + 3 + 1) float32 and an int64
        index
      - the trace state, 1 KiB per ray (as render.render_bytes)
      - the largest sweep, at most nrays x (NUM_IMAGE_SOURCE + 1) rows of
        32 B, and its order table of rows / SWEEP_RAYS x nblocks x 4 B

    The concatenated outputs of all chunks are the caller's."""
    sweep_rows = nrays * (NUM_IMAGE_SOURCE + 1)
    return (
        2 * nrays * (nreflections * 48 + NUM_IMAGE_SOURCE * 56)
        + nrays * 1024
        + sweep_rows * 32
        + -(-sweep_rows // SWEEP_RAYS) * nblocks * 4
    )


def trace(
    scene_or_soup,
    mic,
    source,
    directions,
    nreflections: int,
    *,
    ray_chunk: int | None = None,
    impl: str = "auto",
    device=None,
) -> TraceOutputs:
    """Dense trace of all rays (the host loop of rayverb_tpu/ops/trace.py,
    :973): TraceOutputs in the caller's ray order, on the soup's device (a
    Scene is compiled onto ``device``, None: the card).

    ray_chunk None traces all rays in one pass when ``trace_bytes`` fits
    the card's plan (render.memory_budget; no limit on the CPU), else in
    chunks of the largest power of two of rays that fits; an explicit
    ray_chunk (DEFAULT_RAY_CHUNK is the JAX default) chunks at that size.
    As in the JAX function, the rays are padded with +z directions to a
    multiple of the chunk, the chunks' outputs are concatenated on the
    device and cut back to N. The chunk size never changes results, and
    neither does ray order: the rays are traced in render.ray_schedule's
    order, made on the soup's device as render_fused makes it, and the
    outputs are put back in the caller's order.

    Each chunk is a span rv.trace (attribute first, its first ray), as in
    render_fused; in a stats call the sweeps add their executed pair tests
    and live rows into the call's accumulator (profiling.pair_sums)."""
    from .render import choose_ray_chunk, memory_budget, ray_schedule

    soup = (
        scene_or_soup
        if isinstance(scene_or_soup, TriangleSoup)
        else soup_from_scene(scene_or_soup, device=device)
    )
    directions = _f32(directions, soup.device)
    n = directions.shape[0]
    if n == 0:
        raise ValueError("need at least one ray")
    nblocks = soup.block_aabb.shape[0]
    chunk = choose_ray_chunk(n, nreflections, nblocks, ray_chunk,
                             memory_budget(soup.device), plan=trace_bytes)
    order, resort = ray_schedule(directions, nblocks)
    if order is not None:
        directions = directions[order]
    nchunks = -(-n // chunk)
    if nchunks * chunk != n:
        pad_dirs = torch.zeros((nchunks * chunk - n, 3), device=soup.device)
        pad_dirs[:, 2] = 1.0
        directions = torch.cat([directions, pad_dirs])
    pieces = []
    for c in range(nchunks):
        with profiling.span("rv.trace", first=c * chunk):
            pieces.append(_trace_impl(
                soup,
                mic,
                source,
                directions[c * chunk : (c + 1) * chunk],
                nreflections=nreflections,
                impl=impl,
                resort=resort,
                stats=profiling.pair_sums(),
            ))
    fields = [
        pieces[0][i] if nchunks == 1 else torch.cat([p[i] for p in pieces])[:n]
        for i in range(len(TraceOutputs._fields))
    ]
    del pieces
    if order is not None:
        inv = _inv_permutation(order)
        fields = [f[inv] for f in fields]
    return TraceOutputs(*fields)
