"""The sweep's schedule in the PyTorch port: table slices, the near-to-far
block order and the 64-bit key merge (rayverb_tpu_torch/ops/intersect.py).

The plain sweep follows the schedule that the CUDA kernel follows. These
tests hold it to the one-slice, table-order sweep (the schedule-free
reference kept below as it was written before slices and orders existed):
closest-hit rows are bit-equal on every schedule, decided rows keep their
verdicts and return real witnesses. They also hold PyTorch twins of the
kernel's merge key and divide pre-test to the tie rule and to the exact
pair test. The cull (block_keep, cull_order) is held to a full walk of
each slice's run of block_order on the vault and on a small hall, block by block to the
reference's entry test at each ray's bound, and a twin of the order
kernel's superblock test to the block test it gates. The kernel itself is
held to the plain version on the card by chip_smoke.py and
tests/test_torch_cull_card.py."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rayverb_tpu import load_scene as jax_load_scene
from rayverb_tpu_torch.constants import EPSILON
from rayverb_tpu_torch.ops import intersect as port_isect
from rayverb_tpu_torch.ops import intersect_cuda
from rayverb_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the box room, a furnished room and the 32-block vault
SCENES = ["large_square", "bedroom", "vault"]
_BIG_I32 = 0x7FFFFFFF


# ---- reference: one slice, table order, no schedule ----------------------


def _ref_slab_pass(origins, dirs, inv, box, best_t):
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


def _ref_tile_min(o, d, tile):
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = tile.T[:, None, :]
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
    cand = torch.amin(
        torch.where(t <= tmin[:, None], r[9].to(torch.int32), _BIG_I32), dim=1
    )
    return tmin, cand


def _table_order_sweep(origins, dirs, packed, block_aabb, t_max, t_decide):
    """(best_t, best_i, executed): every ray walks the blocks in table
    order with one running best."""
    m = origins.shape[0]
    nb = block_aabb.shape[0]
    blk = packed.shape[0] // nb
    best_t = t_max.clone()
    best_i = torch.full((m,), -1, dtype=torch.int32)
    executed = torch.zeros((m,), dtype=torch.int64)
    inv = 1.0 / dirs
    live = t_max > 0
    for b in range(nb):
        active = (
            live & (best_t >= t_decide)
            & _ref_slab_pass(origins, dirs, inv, block_aabb[b], best_t)
        )
        rows = torch.nonzero(active).squeeze(1)
        if rows.numel() == 0:
            continue
        executed[rows] += blk
        tmin, cand = _ref_tile_min(
            origins[rows], dirs[rows], packed[b * blk : (b + 1) * blk]
        )
        bt = best_t[rows]
        bi = best_i[rows]
        better = (tmin < bt) | (
            (tmin == bt) & torch.isfinite(tmin) & ((cand < bi) | (bi < 0))
        )
        best_t[rows] = torch.where(better, tmin, bt)
        best_i[rows] = torch.where(better, cand, bi)
    return best_t, best_i, executed


# ---- inputs -----------------------------------------------------------------


def _soup(assets_dir, name):
    scene = jax_load_scene(
        str(assets_dir / "test_models" / f"{name}.obj"),
        str(assets_dir / "materials" / "mat.json"),
    )
    return port_isect.soup_from_scene(scene, device="cpu"), scene.bounds


def _batch(seed, n, bounds, decided):
    """Rays from inside the scene's box: (o, d, t_max, t_decide). With
    decided=True, point-to-point rows as the trace makes them: half carry an
    any-hit threshold, a few are dead (t_max = 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds
    o = (lo + (hi - lo) * (0.1 + 0.8 * rng.random((n, 3)))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if decided:
        mag = (0.3 + 0.6 * np.linalg.norm(hi - lo) * rng.random(n)).astype(np.float32)
        t_max = (mag * np.float32(1.001) + np.float32(0.01)).astype(np.float32)
        t_max[rng.random(n) < 0.05] = 0.0
        decide = np.where(rng.random(n) < 0.5, mag, 0.0).astype(np.float32)
    else:
        t_max = np.full(n, np.inf, np.float32)
        decide = np.zeros(n, np.float32)
    return tuple(torch.from_numpy(x) for x in (o, d, t_max, decide))


def _orders(kind, o, d, t_max, soup, seed):
    m = o.shape[0]
    nb = soup.block_aabb.shape[0]
    if kind == "table":
        return port_isect.table_order(m, nb, "cpu")
    if kind == "near_to_far":
        return port_isect.block_order(o, d, t_max, soup.block_aabb)
    rng = np.random.default_rng(seed)
    groups = -(-m // port_isect.SWEEP_RAYS)
    rows = np.stack([rng.permutation(nb) for _ in range(groups)])
    return torch.from_numpy(rows.astype(np.int32))


def _slice_counts(nb):
    return sorted({1, 2, 3, max(1, nb // 2)})


def _plain(soup, o, d, t_max, decide, order, slices, counts=None):
    return port_isect.closest_hit_plain(
        o, d, soup.packed, soup.block_aabb, t_max, decide, order, slices,
        counts=counts, with_stats=True,
    )


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---- the plain sweep on every schedule ---------------------------------------


@pytest.mark.parametrize("kind", ["table", "near_to_far", "random"])
@pytest.mark.parametrize("name", SCENES)
def test_closest_rows_equal_on_every_schedule(assets_dir, name, kind):
    soup, bounds = _soup(assets_dir, name)
    o, d, t_max, decide = _batch(1, 300, bounds, decided=False)
    ref_t, ref_i, _ = _table_order_sweep(
        o, d, soup.packed, soup.block_aabb, t_max, decide
    )
    assert bool((ref_i >= 0).any())
    order = _orders(kind, o, d, t_max, soup, 5)
    for slices in _slice_counts(soup.block_aabb.shape[0]):
        bt, bi, _ = _plain(soup, o, d, t_max, decide, order, slices)
        assert torch.equal(_bits(bt), _bits(ref_t)), (kind, slices)
        assert torch.equal(bi, ref_i), (kind, slices)


@pytest.mark.parametrize("kind", ["table", "near_to_far", "random"])
@pytest.mark.parametrize("name", SCENES)
def test_decided_rows_keep_their_verdicts(assets_dir, name, kind):
    """Rows with t_decide > 0 give the exact sweep's verdict on every
    schedule, and a blocker they return is a real hit before t_decide;
    closest-hit rows stay bit-equal."""
    soup, bounds = _soup(assets_dir, name)
    o, d, t_max, decide = _batch(2, 300, bounds, decided=True)
    ex_t, ex_i, _ = _table_order_sweep(
        o, d, soup.packed, soup.block_aabb, t_max, torch.zeros_like(decide)
    )
    verdict_exact = (ex_i < 0) | (ex_t > decide)
    rows = decide > 0
    assert bool((~verdict_exact[rows]).any()) and bool(verdict_exact[rows].any())
    order = _orders(kind, o, d, t_max, soup, 6)
    tiles = soup.packed.view(soup.block_aabb.shape[0], -1, 16)
    orig = tiles[..., 9].reshape(-1).to(torch.int64)
    for slices in _slice_counts(soup.block_aabb.shape[0]):
        bt, bi, _ = _plain(soup, o, d, t_max, decide, order, slices)
        assert torch.equal(((bi < 0) | (bt > decide))[rows], verdict_exact[rows])
        assert torch.equal(_bits(bt)[~rows], _bits(ex_t)[~rows])
        assert torch.equal(bi[~rows], ex_i[~rows])
        witness = rows & (bi >= 0) & (bt < decide)
        for r in torch.nonzero(witness).squeeze(1).tolist():
            row = soup.packed[int(torch.nonzero(orig == int(bi[r]))[0])]
            t_row, i_row = _ref_tile_min(o[r : r + 1], d[r : r + 1], row[None])
            assert _bits(t_row).item() == _bits(bt[r : r + 1]).item()
            assert int(i_row) == int(bi[r])
            assert float(bt[r]) < float(decide[r])


@pytest.mark.parametrize("decided", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_one_slice_table_order_reproduces_reference(assets_dir, name, decided):
    """One slice in table order is the schedule-free sweep: outputs and
    executed-pair counters equal bit for bit, decided rows included."""
    soup, bounds = _soup(assets_dir, name)
    o, d, t_max, decide = _batch(3, 257, bounds, decided=decided)
    want = _table_order_sweep(o, d, soup.packed, soup.block_aabb, t_max, decide)
    order = port_isect.table_order(o.shape[0], soup.block_aabb.shape[0], "cpu")
    got = _plain(soup, o, d, t_max, decide, order, 1)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


def test_counters_count_blocks_per_slice(assets_dir):
    """Executed pairs are SWEEP_BLOCK per block and slice a ray took part
    in: more slices cull less, never below the one-slice count."""
    soup, bounds = _soup(assets_dir, "vault")
    o, d, t_max, decide = _batch(4, 300, bounds, decided=False)
    order = port_isect.block_order(o, d, t_max, soup.block_aabb)
    one = _plain(soup, o, d, t_max, decide, order, 1)[2]
    for slices in (2, 4, 16):
        ex = _plain(soup, o, d, t_max, decide, order, slices)[2]
        assert bool((ex % port_isect.SWEEP_BLOCK == 0).all())
        assert int(ex.max()) <= soup.num_padded
        assert int(ex.sum()) >= int(one.sum())


@pytest.mark.parametrize("slices", [1, 3])
def test_plain_chunks_are_invisible(assets_dir, monkeypatch, slices):
    """The plain sweep's chunks of (slice, group) pairs do not show in its
    results: one group per chunk gives the default chunk's bits and
    counters, on a batch whose length is not a multiple of SWEEP_RAYS."""
    soup, bounds = _soup(assets_dir, "vault")
    o, d, t_max, decide = _batch(5, 301, bounds, decided=True)
    order = port_isect.block_order(o, d, t_max, soup.block_aabb)
    ref = _plain(soup, o, d, t_max, decide, order, slices)
    monkeypatch.setattr(port_isect, "PLAIN_RAY_CHUNK", port_isect.SWEEP_RAYS)
    got = _plain(soup, o, d, t_max, decide, order, slices)
    assert torch.equal(_bits(ref[0]), _bits(got[0]))
    assert torch.equal(ref[1], got[1]) and torch.equal(ref[2], got[2])


def test_dead_rows_return_their_bound():
    """Rows with t_max <= 0 (or NaN) are never swept: (t_max, -1) back, bit
    for bit, and no executed pairs."""
    v0 = np.array([[-1.0, -1.0, 2.0]], np.float32)
    e0 = np.array([[3.0, 0.0, 0.0]], np.float32)
    e1 = np.array([[0.0, 3.0, 0.0]], np.float32)
    from rayverb_tpu_torch.params import soup_from_numpy

    soup = soup_from_numpy(
        device="cpu",
        **port_isect.scene_fields(
            v0, e0, e1, np.zeros(1, np.int32),
            np.full((1, 8), 0.9, np.float32), np.full((1, 8), 0.5, np.float32),
        ),
    )
    t_max = torch.tensor([0.0, -0.0, -3.5, float("nan"), float("inf"), 5.0])
    o = torch.zeros((6, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(6, 1)
    decide = torch.zeros(6)
    order, slices, counts = port_isect.sweep_schedule(o, d, t_max, None, soup)
    bt, bi, ex = _plain(soup, o, d, t_max, decide, order, slices, counts)
    assert torch.equal(_bits(bt[:4]), _bits(t_max[:4]))
    assert bi[:4].tolist() == [-1] * 4 and ex[:4].tolist() == [0] * 4
    assert bi[4:].tolist() == [0, 0] and bt[4:].tolist() == [2.0, 2.0]


# ---- the schedule ---------------------------------------------------------------


def test_sweep_slices_fill_the_card():
    """Closest-hit batches take CLOSEST_SLICES; decided batches take as
    many slices as fill DECIDED_TARGET_CTAS thread blocks, one for a batch
    that fills them alone; never more than nblocks // 2."""
    nb = 32
    for m in (1, 777, 10_000, 50_000, 1_000_000):
        groups = -(-m // port_isect.SWEEP_RAYS)
        assert port_isect.sweep_slices(m, nb) == min(port_isect.CLOSEST_SLICES, nb // 2)
        s = port_isect.sweep_slices(m, nb, decided=True)
        assert 1 <= s <= nb // 2
        assert groups * s >= min(port_isect.DECIDED_TARGET_CTAS, groups * (nb // 2))
    assert port_isect.sweep_slices(777, 8) == 4
    assert port_isect.sweep_slices(10_000, 32, decided=True) == 2
    assert port_isect.sweep_slices(50_000, 32, decided=True) == 1


def _block_order_numpy(o, d, t_max, aabb):
    """Float32 numpy twin of block_order: the same elementwise IEEE
    operations, ties by block index through a stable sort."""
    r = port_isect.SWEEP_RAYS
    m, nb = o.shape[0], aabb.shape[0]
    groups = -(-m // r)
    live = np.zeros(groups * r, np.uint8)
    live[:m] = t_max > 0
    rep = np.minimum(np.arange(groups) * r + live.reshape(groups, r).argmax(1), m - 1)
    orep, drep = o[rep][:, None, :], d[rep][:, None, :]
    inv = np.float32(1.0) / drep
    tn = tf = None
    for a in range(3):
        lo, hi = aabb[:, a], aabb[:, 3 + a]
        near = (lo - orep[..., a]) * inv[..., a]
        far = (hi - orep[..., a]) * inv[..., a]
        tna, tfa = np.minimum(near, far), np.maximum(near, far)
        zero = np.abs(drep[..., a]) < np.float32(1e-30)
        inside = (orep[..., a] >= lo) & (orep[..., a] <= hi)
        tna = np.where(zero, np.where(inside, -np.inf, np.inf), tna).astype(np.float32)
        tfa = np.where(zero, np.where(inside, np.inf, -np.inf), tfa).astype(np.float32)
        tn = tna if tn is None else np.maximum(tn, tna)
        tf = tfa if tf is None else np.minimum(tf, tfa)
    meets = tf >= np.maximum(tn, np.float32(EPSILON))
    rank = np.where(meets, np.maximum(tn, np.float32(0.0)), np.float32(np.inf))
    bits = rank.astype(np.float32).view(np.int32) & 0x7FFFFFFF
    return np.argsort(bits, axis=1, kind="stable").astype(np.int32)


@pytest.mark.parametrize("name", SCENES)
def test_order_table_is_device_independent(assets_dir, name):
    """block_order (the order kernel's plain version) equals a float32
    numpy twin bit for bit, whatever the inputs' strides and the batch's
    ragged edge: it uses only elementwise IEEE operations and an integer
    sort, so a CUDA device computes the same table."""
    soup, bounds = _soup(assets_dir, name)
    o, d, t_max, _ = _batch(8, 333, bounds, decided=True)
    aabb = soup.block_aabb
    want = _block_order_numpy(o.numpy(), d.numpy(), t_max.numpy(), aabb.numpy())
    got = port_isect.block_order(o, d, t_max, aabb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    wide = torch.zeros((333, 7))
    wide[:, 2:5] = o
    strided = port_isect.block_order(wide[:, 2:5], d.T.contiguous().T, t_max, aabb)
    assert torch.equal(strided, got)
    for row in got:
        assert sorted(row.tolist()) == list(range(aabb.shape[0]))


def test_order_of_a_dead_group_is_the_table_order_of_its_ranks(assets_dir):
    soup, bounds = _soup(assets_dir, "vault")
    o, d, t_max, _ = _batch(9, 200, bounds, decided=False)
    t_max[:128] = 0.0
    got = port_isect.block_order(o, d, t_max, soup.block_aabb)
    want = _block_order_numpy(o.numpy(), d.numpy(), t_max.numpy(), soup.block_aabb.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_schedule_checks_and_cpu_tensors():
    aabb = torch.zeros((8, 8))
    o = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="order"):
        port_isect.check_schedule(torch.zeros((2, 8), dtype=torch.int32), 1, 5, 8)
    with pytest.raises(ValueError, match="slices"):
        port_isect.check_schedule(torch.zeros((1, 8), dtype=torch.int32), 9, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        intersect_cuda.block_order_cuda(o, o, torch.ones(5), aabb, torch.zeros((1, 8)), 1)
    assert isinstance(intersect_cuda.order_launches, int)


# ---- twins of the kernel's merge key and divide pre-test ----------------------

_F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
_T = st.floats(min_value=2.0**-12, max_value=2.0**14, width=32)  # > EPSILON


def _tie_rule_fold(t_max, slice_t, slice_i):
    """The kernel's and the plain version's per-row tie rule, folded over
    the hits the slices found, in slice order, from (t_max, -1)."""
    bt = t_max.clone()
    bi = torch.full(t_max.shape, -1, dtype=torch.int32)
    for t, i in zip(slice_t, slice_i):
        better = (i >= 0) & (
            (t < bt) | ((t == bt) & torch.isfinite(t) & ((i < bi) | (bi < 0)))
        )
        bt = torch.where(better, t, bt)
        bi = torch.where(better, i, bi)
    return bt, bi


@settings(max_examples=150, deadline=None)
@given(
    rows=st.lists(
        st.tuples(
            st.sampled_from(["finite", "inf", "dead", "nan"]),
            _T,
            st.lists(
                st.tuples(
                    st.sampled_from(["none", "hit", "at_max", "tie"]),
                    _T,
                    st.integers(0, (1 << 24) - 1),
                ),
                min_size=1, max_size=6,
            ),
        ),
        min_size=1, max_size=12,
    )
)
def test_key_merge_is_the_tie_rule(rows):
    """The minimum of pack_keys over slices, unpacked, equals the tie rule:
    smallest t, then lowest index, t == t_max accepted, -1 last; dead rows
    come back as (t_max, -1)."""
    slices = max(len(r[2]) for r in rows)
    t_max = torch.empty(len(rows))
    slice_t = torch.empty((slices, len(rows)))
    slice_i = torch.full((slices, len(rows)), -1, dtype=torch.int32)
    for j, (kind, bound, results) in enumerate(rows):
        t_max[j] = {"finite": bound, "inf": float("inf"), "dead": -bound,
                    "nan": float("nan")}[kind]
        slice_t[:, j] = t_max[j]
        if kind in ("dead", "nan"):
            continue
        shared = min(results[0][1], bound)
        for s, (what, t, idx) in enumerate(results):
            if what == "hit" and t <= t_max[j]:
                slice_t[s, j], slice_i[s, j] = t, idx
            elif what == "at_max" and kind == "finite":
                slice_t[s, j], slice_i[s, j] = t_max[j], idx
            elif what == "tie":
                slice_t[s, j], slice_i[s, j] = shared, idx
    want_t, want_i = _tie_rule_fold(t_max, slice_t, slice_i)
    got_t, got_i = port_isect.unpack_keys(
        torch.amin(port_isect.pack_keys(slice_t, slice_i), dim=0)
    )
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_i, want_i)


_SLACK = 1.0 + 2.0**-20


def _divide_may_accept(ow, dw, bt):
    """PyTorch twin of divide_may_accept in csrc/closest_hit.cu."""
    opposite = ((ow > 0) & (dw < 0)) | ((ow < 0) & (dw > 0))
    beyond = ow.abs() > bt * dw.abs() * _SLACK
    return (dw.abs() >= EPSILON) & opposite & ~beyond


def _accepted_by_t(ow, dw, bt):
    """What the full test requires of t alone: not degenerate, t > EPSILON
    and t <= best_t."""
    t = -ow / torch.where(dw.abs() < EPSILON, 1.0, dw)
    return (dw.abs() >= EPSILON) & (t > EPSILON) & (t <= bt), t


_F32_ROOM = st.floats(min_value=-100.0, max_value=100.0, width=32)


@settings(max_examples=200, deadline=None)
@given(
    pairs=st.lists(
        st.tuples(
            st.one_of(_F32_ROOM, _F32), st.one_of(_F32_ROOM, _F32),
            st.one_of(_F32.map(abs), st.just(float("inf"))),
            st.integers(-3, 3),
        ),
        min_size=1, max_size=64,
    )
)
def test_divide_pretest_never_rejects_an_accepted_pair(pairs):
    """For random (ow, dw, best_t), and for best_t within a few ulps of the
    quotient itself: every pair whose t the full test accepts passes the
    pre-test."""
    ow = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    dw = torch.tensor([p[1] for p in pairs], dtype=torch.float32)
    bt = torch.tensor([p[2] for p in pairs], dtype=torch.float32)
    ulps = torch.tensor([p[3] for p in pairs])
    _, t = _accepted_by_t(ow, dw, bt)
    near = t.clone()
    for _ in range(3):
        up = torch.nextafter(near, torch.full_like(near, float("inf")))
        down = torch.nextafter(near, torch.full_like(near, -float("inf")))
        near = torch.where(ulps > 0, up, torch.where(ulps < 0, down, near))
        ulps = ulps - ulps.sign()
    for bound in (bt, torch.where(torch.isfinite(near), near.abs(), bt)):
        ok, _ = _accepted_by_t(ow, dw, bound)
        assert not bool((ok & ~_divide_may_accept(ow, dw, bound)).any())


def test_divide_pretest_at_the_rounding_edge():
    """Room-scale pairs with best_t at the rounded quotient itself and a
    few ulps either side: the pre-test rejects none that the full test
    accepts (with no slack, |ow| > best_t*|dw| would reject some)."""
    rng = np.random.default_rng(11)
    n = 200_000
    ow = torch.from_numpy((rng.standard_normal(n) * 3).astype(np.float32))
    dw = torch.from_numpy((rng.standard_normal(n) * 0.7).astype(np.float32))
    _, t = _accepted_by_t(ow, dw, torch.full_like(ow, float("inf")))
    rejected_without_slack = 0
    for steps in range(-3, 4):
        bound = t.abs()
        for _ in range(abs(steps)):
            bound = torch.nextafter(bound, torch.full_like(bound, steps * float("inf")))
        ok, _ = _accepted_by_t(ow, dw, bound)
        assert not bool((ok & ~_divide_may_accept(ow, dw, bound)).any()), steps
        rejected_without_slack += int((ok & (ow.abs() > bound * dw.abs())).sum())
    assert rejected_without_slack > 0


def test_divide_pretest_rejects_what_it_can_prove():
    """The pre-test is exact but not empty: wrong-way planes, degenerate
    rows and planes beyond best_t are rejected; a plane just before best_t
    and every plane at best_t = inf pass."""
    ow = torch.tensor([1.0, 1.0, 2.0, 2.0, 2.0, 2.0], dtype=torch.float32)
    dw = torch.tensor([1.0, 1e-5, 1.0, -1.0, -1.0, -1e-3], dtype=torch.float32)
    bt = torch.tensor([10.0, 10.0, 10.0, 1.9, 2.0, float("inf")], dtype=torch.float32)
    got = _divide_may_accept(ow, dw, bt).tolist()
    assert got == [False, False, False, False, True, True]


# ---- the cull ---------------------------------------------------------------


@pytest.fixture(scope="module")
def small_hall(tmp_path_factory):
    """The benchmark's hall generator at ~20,000 triangles: 256 blocks, so
    that a group needs few of them."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench" / "scenes" / "gen_hall.py"
    spec = importlib.util.spec_from_file_location("gen_hall", path)
    gen_hall = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_hall)
    out = tmp_path_factory.mktemp("hall") / "hall.obj"
    gen_hall.generate(str(out), 20_000)
    scene = jax_load_scene(str(out), str(Path(__file__).resolve().parents[1]
                                          / "assets" / "materials" / "mat.json"))
    soup = port_isect.soup_from_scene(scene, device="cpu")
    assert soup.block_aabb.shape[0] == 256
    return soup, scene.bounds


def _cull_soup(assets_dir, small_hall, name):
    return small_hall if name == "hall" else _soup(assets_dir, name)


def _cull_batch(seed, n, bounds, decided):
    """_batch's rays, with a dead group (rays 32-63), every 7th ray along
    an axis (the slab test's |d| < 1e-30 branch on two axes), every 11th
    with one component of 1e-31, and, where decided, closest-hit rows of
    t_max +inf among the any-hit rows."""
    o, d, t_max, decide = _batch(seed, n, bounds, decided)
    sign = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)[:, None]
    axes = torch.eye(3)[torch.arange(n) % 3] * sign
    d = torch.where((torch.arange(n) % 7 == 0)[:, None], axes, d)
    d[torch.arange(n) % 11 == 5, 1] = 1e-31
    if decided:
        t_max[torch.arange(n) % 5 == 0] = float("inf")
    t_max[32:64] = 0.0
    return o, d, t_max, decide


def _need_at_bound(o, d, t_max, decide, aabb):
    """(m, nb) the reference's entry test at each ray's bound: live,
    undecided there, its segment meets the box."""
    inv = 1.0 / d
    cand = (t_max > 0) & (t_max >= decide)
    return torch.stack(
        [cand & _ref_slab_pass(o, d, inv, box, t_max) for box in aabb], dim=1)


@pytest.mark.parametrize("decided", [False, True])
@pytest.mark.parametrize("name", ["vault", "hall"])
def test_cull_keeps_every_hit_and_pair_count(assets_dir, small_hall, name, decided):
    """The culled schedule gives the full walk's Hit bit for bit and its
    executed pairs per ray and per row kind, closest-hit and decided rows
    alike (the same witness), with the live rows counted as before."""
    soup, bounds = _cull_soup(assets_dir, small_hall, name)
    o, d, t_max, decide = _cull_batch(21, 2_500, bounds, decided)
    given = decide if decided else None
    kinds = ((0, 0, 1_000), (3, 1_000, 2_500))
    acc = torch.zeros(profiling.PAIR_SUMS, dtype=torch.int64)
    order, slices, counts = port_isect.sweep_schedule(o, d, t_max, given, soup, acc)
    full = port_isect.block_order(o, d, t_max, soup.block_aabb)
    want_acc = torch.zeros(profiling.PAIR_SUMS, dtype=torch.int64)
    args = (o, d, soup.packed, soup.block_aabb, t_max, decide)
    got = port_isect.closest_hit_plain(*args, order, slices, counts=counts,
                                       with_stats=True, pair_sums=acc, kinds=kinds)
    want = port_isect.closest_hit_plain(*args, full, slices, with_stats=True,
                                        pair_sums=want_acc, kinds=kinds)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool((want[1] >= 0).any()) and int(want[2].sum()) > 0
    e = profiling.ORDER_ENTRIES
    assert torch.equal(acc[:e], want_acc[:e])
    nb = soup.block_aabb.shape[0]
    assert int(acc[e]) == int(counts.sum()) and int(acc[e + 1]) == order.shape[0] * nb
    # the cull engages, and the dead group walks nothing
    assert int(counts.sum()) < order.shape[0] * nb and int(counts[1].sum()) == 0
    if name == "hall":  # unsorted rays: groups far less coherent than a trace's
        assert int(counts.sum()) < order.shape[0] * nb // 2


@pytest.mark.parametrize("decided", [False, True])
@pytest.mark.parametrize("name", ["vault", "hall"])
def test_cull_drops_only_blocks_no_ray_needs(assets_dir, small_hall, name, decided):
    """block_keep is the reference's entry test at each ray's bound, OR'd
    over the group: no dropped block is one a ray needs there, and each
    kept block is. cull_order puts each run's kept blocks first and the
    others after, each in the order's order, and counts the kept."""
    soup, bounds = _cull_soup(assets_dir, small_hall, name)
    o, d, t_max, decide = _cull_batch(22, 700, bounds, decided)
    given = decide if decided else None
    need = _need_at_bound(o, d, t_max, decide if decided else torch.zeros_like(decide),
                          soup.block_aabb)
    groups = -(-o.shape[0] // port_isect.SWEEP_RAYS)
    pad = groups * port_isect.SWEEP_RAYS - o.shape[0]
    want = torch.cat([need, need.new_zeros((pad, need.shape[1]))]).view(
        groups, port_isect.SWEEP_RAYS, -1).any(dim=1)
    keep = port_isect.block_keep(o, d, t_max, given, soup.block_aabb)
    assert torch.equal(keep, want)
    full = port_isect.block_order(o, d, t_max, soup.block_aabb)
    nb = soup.block_aabb.shape[0]
    for slices in (1, 3, 8):
        order, counts = port_isect.cull_order(full, keep, slices)
        for g in range(groups):
            for s, (f, e) in enumerate(port_isect.slice_bounds(nb, slices)):
                run = full[g, f:e].tolist()
                kept = [b for b in run if keep[g, b]]
                assert order[g, f:e].tolist() == kept + [b for b in run if not keep[g, b]]
                assert int(counts[g, s]) == len(kept)


def test_cull_with_no_bounds_and_no_rays(assets_dir):
    """t_max and t_decide absent: every ray live at +inf; an empty batch
    gives empty tables."""
    soup, bounds = _soup(assets_dir, "vault")
    o, d, t_max, _ = _batch(23, 100, bounds, decided=False)
    none = port_isect.block_keep(o, d, None, None, soup.block_aabb)
    assert torch.equal(none, port_isect.block_keep(o, d, t_max, torch.zeros(100),
                                                   soup.block_aabb))
    order, slices, counts = port_isect.sweep_schedule(o[:0], d[:0], None, None, soup)
    assert order.shape == (0, 32) and counts.shape == (0, slices)


def _need_twin(o, d, bt, box):
    """PyTorch twin of box_need in csrc/closest_hit.cu: fminf and fmaxf
    (torch.fmin, torch.fmax) over the three slabs, |d| < 1e-30 by the
    origin's side."""
    inv = 1.0 / d
    tn = tf = None
    for a in range(3):
        lo, hi, oa = box[..., a], box[..., 3 + a], o[..., a]
        near = (lo - oa) * inv[..., a]
        far = (hi - oa) * inv[..., a]
        tna, tfa = torch.fmin(near, far), torch.fmax(near, far)
        zero = d[..., a].abs() < 1e-30
        inside = (oa >= lo) & (oa <= hi)
        inf = torch.full_like(tna, float("inf"))
        tna = torch.where(zero, torch.where(inside, -inf, inf), tna)
        tfa = torch.where(zero, torch.where(inside, inf, -inf), tfa)
        tn = tna if tn is None else torch.fmax(tn, tna)
        tf = tfa if tf is None else torch.fmin(tf, tfa)
    return (tf >= torch.fmax(tn, torch.tensor(EPSILON))) & (tn <= bt)


def _superblock_never_rejects(o, d, bt, aabb):
    """Every (ray, block) that the block test accepts, the test of the
    block's superblock (super_aabb) accepts; returns the share of (ray,
    superblock) pairs it rejects."""
    sup = torch.from_numpy(port_isect.super_aabb(aabb.numpy()))
    per = min(aabb.shape[0], port_isect.SUPER_BLOCKS)
    fine = _need_twin(o[:, None], d[:, None], bt[:, None], aabb[None])
    coarse = _need_twin(o[:, None], d[:, None], bt[:, None], sup[None])
    owner = torch.arange(aabb.shape[0]) // per
    assert not bool((fine & ~coarse[:, owner]).any())
    return float((~coarse).float().mean())


_COORD = st.one_of(
    st.floats(min_value=-50.0, max_value=50.0, width=32),
    st.sampled_from([0.0, -0.0, 1e-30, 3e-31, -1e-40, 1e30, -1e30, 1e38, 5.0, -5.0]),
)
_DIR = st.one_of(
    st.floats(min_value=-1.0, max_value=1.0, width=32),
    st.sampled_from([0.0, -0.0, 1e-30, -1e-30, 9.99e-31, 1e-29, 1e-40, 1.0, -1.0]),
)


@settings(max_examples=200, deadline=None)
@given(
    boxes=st.lists(st.tuples(*[_COORD] * 6), min_size=1, max_size=40),
    rays=st.lists(
        st.tuples(st.tuples(*[_COORD] * 3), st.tuples(*[_DIR] * 3),
                  st.one_of(st.just(float("inf")),
                            st.floats(min_value=0.0, max_value=100.0, width=32)),
                  st.integers(-1, 5)),
        min_size=1, max_size=24),
)
def test_superblock_test_never_rejects_an_accepted_block(boxes, rays):
    """For random and adversarial boxes (degenerate, the empty blocks' far
    point, overflowing slabs) and rays (axis-parallel, tiny and denormal
    components, origins on a box's faces, bounds at +inf and at a box's
    entry), a superblock's box passes every ray that one of its blocks
    passes."""
    nb = 1 << (len(boxes) - 1).bit_length()
    aabb = torch.zeros((max(nb, 1), 8))
    for i in range(aabb.shape[0]):
        lo_hi = torch.tensor(boxes[i % len(boxes)], dtype=torch.float32).view(2, 3)
        aabb[i, 0:3], aabb[i, 3:6] = lo_hi.min(0).values, lo_hi.max(0).values
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    bt = torch.tensor([r[2] for r in rays], dtype=torch.float32)
    # origins on a face of a box, bounds at a box's entry
    face = torch.tensor([r[3] for r in rays])
    for j, f in enumerate(face.tolist()):
        if f >= 0:
            b = aabb[f % aabb.shape[0]]
            o[j, f % 3] = b[(f % 3) + 3 * (f % 2)]
            tn, _ = port_isect._slab(o[j], d[j], 1.0 / d[j], b)
            if torch.isfinite(tn) and tn > 0:
                bt[j] = tn
    _superblock_never_rejects(o, d, bt, aabb)


def test_superblock_test_on_the_hall_and_its_edges(small_hall):
    """The small hall's table (its empty blocks' far points included)
    against 20,000 rays from inside it, every 4th along an axis or with a
    component of 1e-30 or below, a tenth aimed at the far point, bounds
    +inf, finite and at a block's entry: no accepted block is rejected by
    its superblock, and most (ray, superblock) pairs are rejected."""
    soup, bounds = small_hall
    rng = np.random.default_rng(31)
    n = 20_000
    lo, hi = bounds
    o = torch.from_numpy((lo + (hi - lo) * rng.random((n, 3))).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    pick = torch.from_numpy(rng.integers(0, 3, n))
    tiny = torch.tensor([0.0, -0.0, 1e-30, 9.99e-31, 1e-40])
    tiny = tiny[torch.from_numpy(rng.integers(0, 5, n))]
    odd = torch.arange(n) % 4 == 0
    d[odd, pick[odd]] = tiny[odd]
    far = torch.arange(n) % 10 == 3
    d[far] = torch.nn.functional.normalize(1e30 - o[far], dim=1)
    bt = torch.from_numpy(np.select([rng.random(n) < 0.4, rng.random(n) < 0.5],
                                    [np.inf, rng.uniform(0.1, 60, n)], 0.0).astype(np.float32))
    aabb = soup.block_aabb
    entry, _ = port_isect._slab(o, d, 1.0 / d, aabb[torch.from_numpy(rng.integers(0, 158, n))])
    at_entry = (torch.arange(n) % 10 == 7) & torch.isfinite(entry) & (entry > 0)
    bt = torch.where(at_entry, entry, bt)
    assert _superblock_never_rejects(o, d, bt, aabb) > 0.5
