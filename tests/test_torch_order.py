"""The order kernel's schedule (rayverb_tpu_torch/csrc/closest_hit.cu,
closest_hit_order) against its plain versions, intersect.block_order and
its cull (block_keep, cull_order).

The kernel cannot run here, so a numpy twin follows its schedule step by
step: the representative ray by ballot, the ranks, the finite keys
compacted by ballot prefix sums with a finite mask per 32 blocks, the +inf
blocks placed from that mask, and the finite keys sorted by the warp's
register bitonic network (k <= 32) or by the buffer's bitonic network over
the next power of two. The twin must equal block_order bit for bit on
the edge cases of ops/order_check.py and on hypothesis' inputs. A second
twin follows the kernel's cull (superblock ballots, each block tested
against the rays that met its superblock, each slice's run written in two
ballot passes) and must equal cull_order of block_order and block_keep
bit for bit, order and counts. The
kernel itself is held to cull_order of block_order and block_keep on the
card by chip_smoke.py (phase order_vs_plain) and
tests/test_torch_cull_card.py. The wrapper's launch rule (order_launch) is tested at the
table sizes that matter."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rayverb_tpu_torch.constants import EPSILON
from rayverb_tpu_torch.ops import intersect_cuda
from rayverb_tpu_torch.ops.intersect import (
    SWEEP_RAYS, block_keep, block_order, cull_order, slice_bounds, super_aabb,
)
from rayverb_tpu_torch.ops.order_check import order_cases, order_k, order_keys

torch.set_num_threads(1)

INF_BITS = 0x7F800000
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
LANES = np.arange(32)


def _ranks(o, d, t_max, aabb):
    """(groups, nb) rank bits and (groups, nb) met-but-overflowed flags,
    with the kernel's float32 operations; the representative ray of each
    group is its first live ray (the ballot's lowest set lane), else its
    first row."""
    m, nb = o.shape[0], aabb.shape[0]
    groups = -(-m // SWEEP_RAYS)
    rep = np.empty(groups, np.int64)
    for g in range(groups):
        rays = np.arange(g * SWEEP_RAYS, min((g + 1) * SWEEP_RAYS, m))
        live = np.flatnonzero(t_max[rays] > 0)
        rep[g] = rays[live[0]] if live.size else rays[0]
    orep, drep = o[rep][:, None, :], d[rep][:, None, :]
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = np.float32(1.0) / drep
        tn = tf = None
        for a in range(3):
            lo, hi = aabb[:, a], aabb[:, 3 + a]
            near = (lo - orep[..., a]) * inv[..., a]
            far = (hi - orep[..., a]) * inv[..., a]
            tna, tfa = np.fmin(near, far), np.fmax(near, far)
            zero = np.abs(drep[..., a]) < np.float32(1e-30)
            inside = (orep[..., a] >= lo) & (orep[..., a] <= hi)
            tna = np.where(zero, np.where(inside, -np.inf, np.inf), tna).astype(np.float32)
            tfa = np.where(zero, np.where(inside, np.inf, -np.inf), tfa).astype(np.float32)
            tn = tna if tn is None else np.fmax(tn, tna)
            tf = tfa if tf is None else np.fmin(tf, tfa)
    meets = tf >= np.fmax(tn, np.float32(EPSILON))
    rank = np.where(meets, np.fmax(tn, np.float32(0.0)), np.float32(np.inf)).astype(np.float32)
    bits = rank.view(np.uint32) & np.uint32(0x7FFFFFFF)
    return bits, meets & (bits == INF_BITS)


def _warp_sort32(v):
    """The kernel's register bitonic sort: one key per lane, shuffles."""
    v = v.copy()
    k = 2
    while k <= 32:
        j = k >> 1
        while j > 0:
            other = v[LANES ^ j]
            keep_min = ((LANES & j) == 0) == ((LANES & k) == 0)
            v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
            j >>= 1
        k <<= 1
    return v


def _warp_sort_buffer(keys, p):
    """The kernel's buffer bitonic sort of keys[0, p): pair q of a stage
    is i = q with a zero bit inserted at j, and i | j."""
    keys = keys.copy()
    q = np.arange(p // 2)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            a, c = keys[i], keys[i | j]
            swap = (a > c) == ((i & k) == 0)
            keys[i] = np.where(swap, c, a)
            keys[i | j] = np.where(swap, a, c)
            j >>= 1
        k <<= 1
    return keys


def _twin(o, d, t_max, aabb):
    """(groups, nb) int32 order rows by the kernel's schedule, and (groups,)
    k: the numpy twin of closest_hit_order."""
    nb = aabb.shape[0]
    bits, _ = _ranks(o, d, t_max, aabb)
    words = -(-nb // 32)
    out = np.full(bits.shape, -1, np.int32)
    ks = []
    for g, row_bits in enumerate(bits):
        keys = np.zeros(nb, np.uint64)
        mask = np.zeros(words, np.uint32)
        k = 0
        for w in range(words):  # pass 1: rank, compact, finite mask
            b = 32 * w + LANES
            lane_bits = np.where(b < nb, row_bits[np.minimum(b, nb - 1)], INF_BITS)
            finite = lane_bits != INF_BITS
            below = np.cumsum(finite) - finite
            keys[k + below[finite]] = (
                lane_bits[finite].astype(np.uint64) * np.uint64(nb) + b[finite].astype(np.uint64)
            )
            mask[w] = np.sum(finite.astype(np.uint64) << LANES.astype(np.uint64))
            k += int(finite.sum())
        row = out[g]
        finite_below = 0
        for w in range(words):  # pass 2: +inf blocks after the k finite ones
            b = 32 * w + LANES
            finite = ((int(mask[w]) >> LANES) & 1).astype(bool)
            below = np.cumsum(finite) - finite
            place = (b < nb) & ~finite
            row[k + b[place] - (finite_below + below[place])] = b[place]
            finite_below += int(finite.sum())
        if 0 < k <= 32:
            v = _warp_sort32(np.where(LANES < k, keys[np.minimum(LANES, nb - 1)], ALL_ONES))
            row[:k] = (v[:k] & np.uint64(nb - 1)).astype(np.int32)
        elif k > 32:
            p = 64
            while p < k:
                p <<= 1
            assert p <= nb  # the warp's key buffer holds it
            buf = keys[:p].copy()
            buf[k:] = ALL_ONES
            buf = _warp_sort_buffer(buf, p)
            row[:k] = (buf[:k] & np.uint64(nb - 1)).astype(np.int32)
        ks.append(k)
    return out, np.asarray(ks)


def _check(o, d, t_max, aabb):
    want = block_order(*(torch.from_numpy(x) for x in (o, d, t_max, aabb))).numpy()
    got, k = _twin(o, d, t_max, aabb)
    np.testing.assert_array_equal(got, want)
    return k


# ---- the edge cases of ops/order_check.py ----

CASE_NAMES = ("k0_missed", "k_all_inside", "ties_at_zero", "k31", "k32", "k33",
              "tiny_directions", "overflow_to_inf", "random")
CASES = [(nb, name) for nb in (32, 64, 1024) for name in CASE_NAMES
         if not (name == "k33" and nb < 33)]


@pytest.mark.parametrize("nb,name", CASES, ids=[f"{nb}-{n}" for nb, n in CASES])
def test_twin_equals_block_order_on_edge_cases(nb, name):
    case = {c[0]: c[1:] for c in order_cases(nb)}[name]
    k = _check(*case)
    if name == "k0_missed":
        assert (k == 0).all()
    elif name == "k_all_inside":
        assert (k == nb).all()
    elif name in ("k31", "k32", "k33"):
        assert (k == int(name[1:])).all()
    elif name == "overflow_to_inf":
        _, overflowed = _ranks(*case)
        assert overflowed.any(axis=1).all() and (k > 0).all()
    elif name == "ties_at_zero":
        bits, _ = _ranks(*case)
        assert ((bits == 0).sum(axis=1) > 1).all()


def test_edge_cases_shape_their_groups():
    """Group 1's representative is its 6th ray, group 2 is dead, and the
    last group is ragged (70 rays)."""
    for _, o, d, t_max, aabb in order_cases(32):
        assert o.shape == d.shape == (70, 3) and t_max.shape == (70,)
        assert o.dtype == d.dtype == t_max.dtype == aabb.dtype == np.float32
        assert aabb.shape == (32, 8) and (aabb[:, 3:6] >= aabb[:, 0:3]).all()
    t_max = order_cases(32)[0][3]
    assert (t_max[32:37] == 0).all() and t_max[37] > 0 and (t_max[64:] == 0).all()


@pytest.mark.parametrize("nb", [32, 1024])
def test_order_keys_and_k(nb):
    """order_keys (chip_smoke's k and sort yardstick) are block_order's
    keys: their argsort is its table, and order_k is the twin's k."""
    for _, *case in order_cases(nb):
        args = [torch.from_numpy(x) for x in case]
        keys = order_keys(*args)
        assert torch.equal(torch.argsort(keys, dim=1).to(torch.int32), block_order(*args))
        np.testing.assert_array_equal(order_k(keys).numpy(), _twin(*case)[1])


# ---- the cull ----


def _need(o, d, bound, boxes):
    """(m, n) the kernel's box_need of each ray at its bound against each
    box, in float32 with fminf's and fmaxf's NaN rule (np.fmin, np.fmax)."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
        tn = tf = None
        for a in range(3):
            lo, hi = boxes[None, :, a], boxes[None, :, 3 + a]
            oa = o[:, None, a]
            near = (lo - oa) * inv[:, None, a]
            far = (hi - oa) * inv[:, None, a]
            tna, tfa = np.fmin(near, far), np.fmax(near, far)
            zero = np.abs(d[:, None, a]) < np.float32(1e-30)
            inside = (oa >= lo) & (oa <= hi)
            tna = np.where(zero, np.where(inside, -np.inf, np.inf), tna).astype(np.float32)
            tfa = np.where(zero, np.where(inside, np.inf, -np.inf), tfa).astype(np.float32)
            tn = tna if tn is None else np.fmax(tn, tna)
            tf = tfa if tf is None else np.fmin(tf, tfa)
        return (tf >= np.fmax(tn, np.float32(EPSILON))) & (tn <= bound[:, None])


def _ballot_place(out, row, keep_run, f):
    """The kernel's write of one run: a ballot pass counts its kept
    blocks, a second places each block by ballot prefix sums, kept from f,
    the rest after them. Returns the kept count."""
    n = keep_run.shape[0]
    total = sum(int(keep_run[p0 : p0 + 32].sum()) for p0 in range(0, n, 32))
    kept = rest = 0
    for p0 in range(0, n, 32):
        mine = keep_run[p0 : p0 + 32]
        blocks = row[p0 : p0 + 32]
        kb = np.cumsum(mine) - mine
        rb = np.cumsum(~mine) - ~mine
        out[f + kept + kb[mine]] = blocks[mine]
        out[f + total + rest + rb[~mine]] = blocks[~mine]
        kept += int(mine.sum())
        rest += int((~mine).sum())
    return total


def _cull_twin(o, d, t_max, t_decide, aabb, slices):
    """(order, counts) by the kernel's cull: lane l holds ray l of the
    group; a superblock's ballot gives the candidates (live, undecided at
    their bound) whose segment meets its box; lane j tests block 32 s + j
    against each of them, and a ballot gives the superblock's word of kept
    blocks; then each slice's run of the order is written in two passes."""
    order, _ = _twin(o, d, t_max, aabb)
    m, nb = o.shape[0], aabb.shape[0]
    groups = order.shape[0]
    per = min(nb, 32)
    cand = (t_max > 0) & (t_max >= t_decide)
    met = _need(o, d, t_max, super_aabb(aabb)) & cand[:, None]
    fine = _need(o, d, t_max, aabb)
    out = np.empty_like(order)
    counts = np.zeros((groups, slices), np.int32)
    for g in range(groups):
        rays = np.arange(g * SWEEP_RAYS, min((g + 1) * SWEEP_RAYS, m))
        words = np.zeros(-(-nb // 32), np.uint64)
        for s in range(nb // per):
            ballot = met[rays, s]
            if ballot.any():
                mark = fine[rays[ballot]][:, s * per : (s + 1) * per].any(axis=0)
                words[s] = np.sum(mark.astype(np.uint64) << np.arange(per, dtype=np.uint64))
        row = order[g]
        keep = ((words[row >> 5] >> (row & 31).astype(np.uint64)) & np.uint64(1)).astype(bool)
        for s, (f, e) in enumerate(slice_bounds(nb, slices)):
            counts[g, s] = _ballot_place(out[g], row[f:e], keep[f:e], f)
    return out, counts


def _check_cull(o, d, t_max, t_decide, aabb, slices):
    args = [torch.from_numpy(x) for x in (o, d, t_max, t_decide, aabb)]
    want = cull_order(block_order(*args[:3], args[4]), block_keep(*args), slices)
    got = _cull_twin(o, d, t_max, t_decide, aabb, slices)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    return got[1]


@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("nb,name", CASES, ids=[f"{nb}-{n}" for nb, n in CASES])
def test_cull_twin_equals_cull_order_on_edge_cases(nb, name, slices):
    """The cull twin equals cull_order of block_order and block_keep on
    the order's edge cases, with and without any-hit thresholds (a third
    of the rows decided at their bound, a third past it)."""
    _, o, d, t_max, aabb = {c[0]: c for c in order_cases(nb)}[name]
    for decide in (np.zeros_like(t_max),
                   np.where(np.arange(t_max.shape[0]) % 3 == 1, t_max,
                            np.where(np.arange(t_max.shape[0]) % 3 == 2,
                                     np.float32(np.inf), 0)).astype(np.float32)):
        counts = _check_cull(o, d, t_max, decide, aabb, slices)
        if (t_max[64:] <= 0).all():  # a dead group keeps nothing
            assert counts[2].sum() == 0


# ---- the sorts on either side of 32 keys ----


@pytest.mark.parametrize("k", [1, 2, 17, 31, 32, 33, 63, 64, 65, 200])
def test_twin_sorts(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << 62, k, dtype=np.uint64)
    keys[: k // 3] = keys[0]  # equal keys too
    want = np.sort(keys)
    if k <= 32:
        got = _warp_sort32(np.concatenate([keys, np.full(32 - k, ALL_ONES)]))[:k]
    else:
        p = 64
        while p < k:
            p <<= 1
        got = _warp_sort_buffer(np.concatenate([keys, np.full(p - k, ALL_ONES)]), p)[:k]
    np.testing.assert_array_equal(got, want)


# ---- hypothesis: random tables, rays, bounds and degenerate directions ----


@settings(max_examples=60, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    log_nb=st.integers(0, 7),
    m=st.integers(1, 100),
    degenerate=st.sampled_from(["none", "zero", "tiny", "negzero", "denormal"]),
    inside_share=st.floats(0.0, 1.0),
)
def test_twin_equals_block_order_hypothesis(seed, log_nb, m, degenerate, inside_share):
    rng = np.random.default_rng(seed)
    nb = 1 << log_nb
    lo = rng.uniform(-10, 10, (nb, 3))
    size = rng.uniform(0.1, 12, (nb, 3))
    o = rng.uniform(-8, 8, (m, 3))
    # some boxes around the first ray's origin: rank 0, tied
    around = rng.random(nb) < inside_share
    lo[around] = o[0] - rng.uniform(0.01, 3, (int(around.sum()), 3))
    size[around] = rng.uniform(3.1, 6, (int(around.sum()), 3))
    d = rng.standard_normal((m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if degenerate != "none":
        axis = rng.integers(0, 3, m)
        hit = rng.random(m) < 0.5
        value = {"zero": 0.0, "tiny": 3e-31, "negzero": -0.0, "denormal": 1e-40}[degenerate]
        d[hit, axis[hit]] = value
    t_max = np.select([rng.random(m) < 0.6, rng.random(m) < 0.5],
                      [np.inf, rng.uniform(0.5, 20, m)], rng.choice([0.0, -1.0], m))
    aabb = np.zeros((nb, 8))
    aabb[:, 0:3] = lo
    aabb[:, 3:6] = lo + size
    _check(*(np.ascontiguousarray(x, np.float32) for x in (o, d, t_max, aabb)))


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    log_nb=st.integers(0, 8),
    m=st.integers(1, 100),
    slices=st.integers(1, 9),
    degenerate=st.sampled_from(["none", "zero", "tiny", "negzero", "denormal"]),
)
def test_cull_twin_equals_cull_order_hypothesis(seed, log_nb, m, slices, degenerate):
    """Random tables (empty blocks' far points among them), rays with
    axis-parallel and tiny direction components, finite, infinite and dead
    bounds, and thresholds below, at and above them."""
    rng = np.random.default_rng(seed)
    nb = 1 << log_nb
    lo = rng.uniform(-10, 10, (nb, 3))
    hi = lo + rng.uniform(0.0, 12, (nb, 3))
    empty = rng.random(nb) < 0.2
    lo[empty] = hi[empty] = 1e30
    o = rng.uniform(-8, 8, (m, 3))
    d = rng.standard_normal((m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if degenerate != "none":
        axis = rng.integers(0, 3, m)
        hit = rng.random(m) < 0.5
        value = {"zero": 0.0, "tiny": 3e-31, "negzero": -0.0, "denormal": 1e-40}[degenerate]
        d[hit, axis[hit]] = value
    t_max = np.select([rng.random(m) < 0.5, rng.random(m) < 0.7],
                      [np.inf, rng.uniform(0.5, 20, m)], rng.choice([0.0, -1.0], m))
    t_decide = np.select([rng.random(m) < 0.5, rng.random(m) < 0.5],
                         [0.0, t_max], rng.uniform(0.0, 25, m))
    aabb = np.zeros((nb, 8))
    aabb[:, 0:3] = lo
    aabb[:, 3:6] = hi
    _check_cull(*(np.ascontiguousarray(x, np.float32)
                  for x in (o, d, t_max, t_decide, aabb)), min(slices, nb))


# ---- the wrapper's launch rule ----

SMEM_MAX = 227 * 1024


def _layout_bytes(nb, spill):
    """One warp's shared memory as closest_hit_order lays it out: nb
    64-bit keys unless they spill, then one bit per block in 32-bit words,
    padded to 8 bytes."""
    words = -(-nb // 32)
    return (0 if spill else 8 * nb) + 8 * -(-words // 2)


@pytest.mark.parametrize("nb", [8, 32, 1024, 29_056, 32_768])
@pytest.mark.parametrize("groups", [1, 3, 256, 1563, 31_250])
def test_order_launch(nb, groups):
    launch = intersect_cuda.order_launch(nb, groups)
    assert launch.spill == (_layout_bytes(nb, False) > SMEM_MAX)
    assert launch.smem == launch.warps * _layout_bytes(nb, launch.spill) <= SMEM_MAX
    assert 1 <= launch.warps <= intersect_cuda.ORDER_WARPS
    assert launch.warps <= max(1, -(-groups // intersect_cuda.ORDER_SPREAD_SMS))


def test_order_launch_at_the_ports_tables():
    """No scratch at the vault's 32 or the hall's 1,024 blocks, nor at
    16,384; a scratch at 29,056 and 32,768, whose keys and mask overflow
    one warp's 227 KB."""
    assert intersect_cuda.order_launch(32, 1563) == (8, 2112, False)
    assert intersect_cuda.order_launch(1024, 31_250) == (8, 66_560, False)
    assert intersect_cuda.order_launch(1024, 256) == (2, 16_640, False)
    assert intersect_cuda.order_launch(16_384, 4) == (1, 133_120, False)
    assert intersect_cuda.order_launch(29_056, 4).spill
    assert intersect_cuda.order_launch(32_768, 4) == (1, 4096, True)


def test_block_order_cuda_refuses_cpu_tensors():
    before = intersect_cuda.order_launches
    with pytest.raises(ValueError, match="CUDA"):
        intersect_cuda.block_order_cuda(
            torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5), torch.zeros((8, 8)),
            torch.zeros((1, 8)), 1)
    assert intersect_cuda.order_launches == before
