"""The closest-hit sweep's epilogue in the PyTorch port: the slices' merge
and the Hit mapping that the CUDA kernel closest_hit_sweep does itself
(rayverb_tpu_torch/csrc/closest_hit.cu), and their plain versions
(intersect.unpack_keys of the keys' minimum, intersect.hit_from_raw).

A numpy twin of the kernel's epilogue (per-slice keys, one slice writing
alone, the last arriver's self-cleaning scratch, the seed and the Hit
mapping) is held to the plain merge on every arrival order of the slices;
hit_from_raw is held to the JAX package's own mapping
(rayverb_tpu/ops/intersect_pallas.py:686-690); the plain closest_hit is
held to its output from before the epilogue took over the mapping, and to
the JAX sweep. The kernel itself is held to the plain version on the card
by chip_smoke.py."""

import hashlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rayverb_tpu import load_scene as jax_load_scene
from rayverb_tpu.ops import intersect as jax_isect
from rayverb_tpu.ops import intersect_pallas
from rayverb_tpu_torch.ops import intersect as port_isect

torch.set_num_threads(1)

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
LOW = np.uint64(0xFFFFFFFF)
RAYS = port_isect.SWEEP_RAYS


# ---- numpy twin of the kernel's epilogue -----------------------------------


def _pack(t, i):
    """pack_key: float bits of t << 32 | index as uint32 (-1 last)."""
    hi = np.asarray(t, np.float32).view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | np.asarray(i, np.int64).astype(np.uint32).astype(np.uint64)


def _write_hit(key, bound):
    """write_hit: the Hit of the merged key and the seed (bound, -1)."""
    key = np.minimum(key, _pack(bound, np.full(np.shape(bound), -1)))
    lo = (key & LOW).astype(np.uint32)
    bi = np.where(lo == np.uint32(0xFFFFFFFF), -1, lo.astype(np.int64))
    found = bi >= 0
    t = np.where(found, (key >> np.uint64(32)).astype(np.uint32).view(np.float32), np.inf)
    return t.astype(np.float32), np.where(found, bi, 0), found


def _own_keys(slice_t, slice_i):
    """Each slice's key per ray: its best, or all-ones without a hit."""
    return np.where(slice_i >= 0, _pack(slice_t, slice_i), ALL_ONES)


def _last_arriver(own, bound, arrival, scratch, counter):
    """The last-arriver merge of one launch, slices arriving in the order
    ``arrival`` (P, S) (one order per row, all run at once): each slice
    takes the minimum into ``scratch`` (P, M) for its rays with a hit and
    takes a ticket from ``counter`` (P, groups); the slice whose ticket is
    S - 1 exchanges its group's keys back to all-ones, resets the counter
    and writes the Hit. Rows of ``scratch`` and ``counter`` are updated in
    place; returns the Hit (t, index, hit), each (P, M)."""
    p, s = arrival.shape
    m = own.shape[1]
    groups = -(-m // RAYS)
    out_t = np.full((p, m), np.nan, np.float32)
    out_i = np.full((p, m), -7, np.int64)
    out_h = np.zeros((p, m), bool)
    for step in range(s):
        sl = arrival[:, step]
        mine = own[sl]  # (P, M)
        scratch[...] = np.where(mine != ALL_ONES, np.minimum(scratch, mine), scratch)
        ticket = counter.copy()
        counter += 1
        last = ticket == s - 1  # (P, groups): this slice arrived last
        ray_last = np.repeat(last, RAYS, axis=1)[:, :m]
        if ray_last.any():
            got = np.where(ray_last, scratch, ALL_ONES)
            scratch[ray_last] = ALL_ONES
            counter[last] = 0
            t, i, h = _write_hit(got, np.broadcast_to(bound, (p, m)))
            out_t[ray_last], out_i[ray_last], out_h[ray_last] = t[ray_last], i[ray_last], h[ray_last]
    assert not np.isnan(out_t).any()  # every ray written once
    return out_t, out_i, out_h




def _plain(t_max, slice_t, slice_i):
    """The plain version: unpack_keys of the minimum of pack_keys over the
    slices, then hit_from_raw."""
    raw = port_isect.unpack_keys(torch.amin(port_isect.pack_keys(
        torch.from_numpy(slice_t), torch.from_numpy(slice_i)), dim=0))
    hit = port_isect.hit_from_raw(*raw)
    return hit.t.numpy(), hit.index.numpy(), hit.hit.numpy()


def _rows(rng, m, s):
    """Per-slice raw results of ``m`` rays over ``s`` slices as the sweep
    leaves them: each slice starts at (t_max, -1); rays of every kind:
    t_max finite, +inf, dead (0, negative, NaN); slices that miss, hit,
    hit exactly at t_max, and tie on t with other indices."""
    kind = rng.integers(0, 6, m)
    t_max = np.where(kind == 0, np.inf, rng.uniform(0.5, 40.0, m)).astype(np.float32)
    t_max[kind == 1] = 0.0
    t_max[kind == 2] = -rng.uniform(0.1, 3.0, int((kind == 2).sum()))
    t_max[kind == 3] = np.nan
    slice_t = np.broadcast_to(t_max, (s, m)).copy()
    slice_i = np.full((s, m), -1, np.int32)
    live = t_max > 0
    shared = (np.minimum(t_max, 30.0) * rng.uniform(0.2, 1.0, m)).astype(np.float32)
    for j in range(s):
        what = rng.integers(0, 4, m)
        idx = rng.integers(0, 1 << 24, m).astype(np.int32)
        t = (np.minimum(t_max, 30.0) * rng.uniform(0.01, 1.0, m)).astype(np.float32)
        t = np.maximum(t, np.float32(2e-4))
        for w, value in ((1, t), (2, t_max), (3, shared)):
            pick = live & (what == w) & (value <= t_max) & np.isfinite(value)
            slice_t[j, pick] = value[pick]
            slice_i[j, pick] = idx[pick]
    return t_max, slice_t, slice_i


def _check_twin(t_max, slice_t, slice_i, arrival):
    s, m = slice_t.shape
    own = _own_keys(slice_t, slice_i)
    want = _plain(t_max, slice_t, slice_i)
    if s == 1:
        # one slice writes its rays alone: no scratch
        got = _write_hit(own[0], t_max)
        np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        return want
    groups = -(-m // RAYS)
    p = arrival.shape[0]
    scratch = np.full((p, m), ALL_ONES, np.uint64)
    counter = np.zeros((p, groups), np.int64)
    # two launches on the same scratch: the first leaves it clean
    for _ in range(2):
        got = _last_arriver(own, t_max, arrival, scratch, counter)
        assert (scratch == ALL_ONES).all() and (counter == 0).all()
        np.testing.assert_array_equal(got[0].view(np.int32),
                                      np.broadcast_to(want[0].view(np.int32), (p, m)))
        np.testing.assert_array_equal(got[1], np.broadcast_to(want[1], (p, m)))
        np.testing.assert_array_equal(got[2], np.broadcast_to(want[2], (p, m)))
    return want


@pytest.mark.parametrize("slices", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("m", [32, 77])
def test_twin_equals_plain_merge_in_every_arrival_order(slices, m):
    """Every permutation of the slices' arrival: the twin's Hit equals the
    plain merge's, and the scratch comes back clean. m = 77 ends in a
    partial group of 13 rays."""
    rng = np.random.default_rng(1000 * slices + m)
    t_max, slice_t, slice_i = _rows(rng, m, slices)
    arrival = np.array(list(itertools.permutations(range(slices))), np.int64)
    want = _check_twin(t_max, slice_t, slice_i, arrival)
    assert want[2].any() and not want[2].all()


def test_twin_at_eight_slices_every_order():
    """S = 8 (the closest-hit batches' slice count): all 40,320 arrival
    orders at once on one ragged group of rays."""
    rng = np.random.default_rng(8)
    t_max, slice_t, slice_i = _rows(rng, 29, 8)
    arrival = np.array(list(itertools.permutations(range(8))), np.int64)
    _check_twin(t_max, slice_t, slice_i, arrival)


@settings(max_examples=60, deadline=None)
@given(
    slices=st.sampled_from([8, 16, 6, 11, 53]),
    m=st.integers(1, 100),
    seed=st.integers(0, 2**32 - 1),
    orders=st.integers(1, 16),
)
def test_twin_equals_plain_merge_in_drawn_orders(slices, m, seed, orders):
    """Slice counts whose permutations are too many to list (16: the
    decided batches' cap on the vault; 53: a hall decided batch): arrival
    orders drawn at random."""
    rng = np.random.default_rng(seed)
    t_max, slice_t, slice_i = _rows(rng, m, slices)
    arrival = np.stack([rng.permutation(slices) for _ in range(orders)])
    _check_twin(t_max, slice_t, slice_i, arrival)


def test_twin_edge_rows():
    """Pinned rows: a hit exactly at t_max wins with any index, equal t
    goes to the lowest index, t_max = +inf, dead rows (0, -0.0, negative,
    NaN) miss with t = +inf and index 0."""
    inf = np.float32(np.inf)
    t_max = np.array([5.0, 5.0, inf, inf, 0.0, -0.0, -2.0, np.nan, 3.0], np.float32)
    slice_t = np.broadcast_to(t_max, (3, 9)).copy()
    slice_i = np.full((3, 9), -1, np.int32)
    slice_t[1, 0], slice_i[1, 0] = 5.0, 77          # at t_max
    slice_t[:, 1], slice_i[:, 1] = 2.5, [9, 4, 12]  # ties on t
    slice_t[2, 2], slice_i[2, 2] = 1.25, 0          # index 0 hits
    slice_t[0, 3], slice_i[0, 3] = 7.0, (1 << 24) - 1
    arrival = np.array(list(itertools.permutations(range(3))), np.int64)
    t, i, h = _check_twin(t_max, slice_t, slice_i, arrival)
    assert h.tolist() == [True, True, True, True] + [False] * 5
    assert t.tolist() == [5.0, 2.5, 1.25, 7.0] + [np.inf] * 5
    assert i.tolist() == [77, 4, 0, (1 << 24) - 1] + [0] * 5


# ---- hit_from_raw against the JAX package's mapping -------------------------


def _raw(rng, m, t_max):
    idx = np.where(rng.random(m) < 0.4, -1, rng.integers(0, 1 << 24, m)).astype(np.int32)
    t = np.where(idx >= 0, rng.uniform(1e-4, 50.0, m), t_max).astype(np.float32)
    t[rng.random(m) < 0.05] = np.inf
    return t, idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hit_from_raw_is_the_jax_mapping(monkeypatch, large_square_soup, seed):
    """closest_hit_pallas maps its kernel's raw (best_t, best_i) to a Hit
    at rayverb_tpu/ops/intersect_pallas.py:686-690. The kernel is replaced
    by one that returns numpy raw results (and padding), so those lines
    run on them as they are; hit_from_raw of the same arrays must give the
    same fields."""
    rng = np.random.default_rng(seed)
    m = 300
    t_max = np.where(rng.random(m) < 0.5, np.inf, rng.uniform(0.5, 20.0, m)).astype(np.float32)
    t_max[:7] = [0.0, -0.0, -1.0, np.nan, 1e-30, 3.0, np.inf]
    best_t, best_i = _raw(rng, m, t_max)

    def raw_kernel(rays_t, *args, **kw):
        mp = rays_t.shape[1]
        t = np.concatenate([best_t, rng.uniform(0, 9, mp - m).astype(np.float32)])
        i = np.concatenate([best_i, rng.integers(-1, 9, mp - m).astype(np.int32)])
        return jnp.asarray(t)[None], jnp.asarray(i)[None]

    monkeypatch.setattr(intersect_pallas, "_closest_hit_padded", raw_kernel)
    o = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    want = intersect_pallas.closest_hit_pallas(o, d, large_square_soup, t_max=t_max)
    got = port_isect.hit_from_raw(torch.from_numpy(best_t), torch.from_numpy(best_i))
    np.testing.assert_array_equal(got.t.numpy().view(np.int32),
                                  np.asarray(want.t).view(np.int32))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert got.index.dtype == torch.int64 and got.hit.dtype == torch.bool
    # raw_from_hit gives the raw results back, bit for bit
    back_t, back_i = port_isect.raw_from_hit(got, torch.from_numpy(t_max))
    miss = best_i < 0
    np.testing.assert_array_equal(back_t.numpy().view(np.int32)[~miss],
                                  best_t.view(np.int32)[~miss])
    np.testing.assert_array_equal(back_t.numpy().view(np.int32)[miss],
                                  t_max.view(np.int32)[miss])
    np.testing.assert_array_equal(back_i.numpy(), best_i)


# ---- the plain closest_hit, before and after ------------------------------------

# SHA-256 (first 16 hex digits) of t's bits, index and hit of the plain
# closest_hit on _sweep_batch's batches, computed with the port at commit
# 559e361, whose dispatcher mapped the raw results itself
PREVIOUS = {
    ("vault", "free"): "0c2420fc0863e40d",
    ("vault", "bounded"): "70431cdc23139c35",
    ("vault", "decided"): "e81db94eb7c9235d",
    ("large_square", "free"): "9fd88a01a3f28979",
    # the box room is convex: a row's only hit is its closest, decided or not
    ("large_square", "bounded"): "dbcc0b25069ebf6e",
    ("large_square", "decided"): "dbcc0b25069ebf6e",
}
MATERIALS = {"vault": "vault.json", "large_square": "mat.json"}


def _sweep_batch(bounds, kind, n=400, seed=5):
    """(origins, dirs, t_max or None, t_decide or None), float32 numpy:
    rays inside the scene's bounds; ``free`` unbounded, ``bounded`` with
    finite bounds (an eighth dead), ``decided`` bounded with any-hit
    thresholds on half the rows."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bounds, np.float32)
    o = (lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == "free":
        return o, d, None, None
    mag = rng.uniform(0.5, float(np.linalg.norm(hi - lo)), n).astype(np.float32)
    t_max = (mag * np.float32(1.001) + np.float32(0.01)).astype(np.float32)
    t_max[rng.random(n) < 0.125] = 0.0
    if kind == "bounded":
        return o, d, t_max, None
    return o, d, t_max, np.where(rng.random(n) < 0.5, mag, 0.0).astype(np.float32)


def _digest(hit):
    h = hashlib.sha256()
    h.update(hit.t.numpy().view(np.int32).tobytes())
    h.update(hit.index.numpy().astype(np.int64).tobytes())
    h.update(hit.hit.numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("kind", ["free", "bounded", "decided"])
@pytest.mark.parametrize("name", ["vault", "large_square"])
def test_plain_closest_hit_unchanged_and_matches_jax(assets_dir, name, kind):
    """The plain closest_hit on the vault and on the box room gives the
    bits it gave before the kernel's epilogue took over the Hit mapping,
    and agrees with the JAX package's Pallas sweep run in interpret mode
    (as tests/test_intersect_pallas.py runs it): hits and indices equal, t
    within 1e-4 relative, and on decided rows the same verdict. Both take
    the Woop forms in float32, rounded differently (XLA may fuse
    multiply-adds): on the vault one grazing row differs by 1.55e-5
    relative; kernel_parity's gate holds the port within 5e-4 of float64."""
    scene = jax_load_scene(str(assets_dir / "test_models" / f"{name}.obj"),
                           str(assets_dir / "materials" / MATERIALS[name]))
    o, d, t_max, decide = _sweep_batch(scene.bounds, kind)
    tt = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    soup = port_isect.soup_from_scene(scene, device="cpu")
    got = port_isect.closest_hit(tt(o), tt(d), soup, t_max=tt(t_max), t_decide=tt(decide))
    assert _digest(got) == PREVIOUS[(name, kind)]
    ref = intersect_pallas.closest_hit_pallas(
        o, d, jax_isect.soup_from_scene(scene), interpret=True, t_max=t_max, t_decide=decide)
    closest = np.ones(o.shape[0], bool) if decide is None else decide == 0
    ref_hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy()[closest], ref_hit[closest])
    both = closest & ref_hit
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both], rtol=1e-4)
    np.testing.assert_array_equal(got.index.numpy()[both], np.asarray(ref.index)[both])
    if decide is not None:
        verdict = lambda h, t: (~h) | (t > decide)  # noqa: E731
        np.testing.assert_array_equal(verdict(got.hit.numpy(), got.t.numpy())[~closest],
                                      verdict(ref_hit, np.asarray(ref.t))[~closest])
